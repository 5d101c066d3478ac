"""The port's tracer (`utils/profiling.Tracer`) on the CPU, where a mark
records `perf_counter_ns` in place of the device clock (eager CPU ops are
synchronous), so the same accounting runs as on the card.

* Without a tracer `mark` and `span_on` do nothing, and the eager forward is
  bit-equal with and without one.
* The stages `encode`, `render`, `flow`, `pose` and `tail` partition a
  forward: 1 + render_iters x (2 + 2 x gru_iters) + 1 stages, whose
  device times sum to the first stamp to the last; a training step's
  `forward`, `backward` and `update` hold the refiner's marks nested in
  `forward`.
* The engine's and the trainer's spans nest under their call's root span,
  and every span and stamp of a call shares its id.
* `replays`, `graph_captures` and `encode_3d_calls` count as documented,
  and an export holds them.
* Idle attribution on a synthetic timeline, calibration on synthetic
  pairs, and `export`'s JSON round trip.
* Under an active profiler a span is also a `record_function` of its name.
"""
import contextlib
import dataclasses
import json

import pytest
import torch

from rnnpose_tpu_torch.data.synthetic import SyntheticConfig, kpconv_config, make_synthetic_inputs
from rnnpose_tpu_torch.models.engine import InferenceEngine
from rnnpose_tpu_torch.models.refiner import RefinerConfig
from rnnpose_tpu_torch.models.rnnpose import RNNPose, RNNPoseConfig, init_random_
from rnnpose_tpu_torch.train.loop import Trainer
from rnnpose_tpu_torch.train.optim import OptimizerConfig
from rnnpose_tpu_torch.utils import profiling
from rnnpose_tpu_torch.utils.profiling import END, Tracer

torch.set_num_threads(1)

R, G = 2, 2  # render iterations, inner steps
FORWARD = ["encode"] + R * (["render", "encode"] + G * ["flow", "pose"]) + ["tail"]


def _syn(B):
    return SyntheticConfig(image_size=64, num_verts=128, num_faces=256, subdivisions=2,
                           fx=100.0, fy=100.0, kp_layers=2, kp_dl=0.03, batch_size=B,
                           num_corr=32)


def _model(seed=0):
    kp = kpconv_config(_syn(1))
    model = RNNPose(RNNPoseConfig(
        desc_kp=dataclasses.replace(kp, final_feats_dim=32),
        ctx_kp=dataclasses.replace(kp, final_feats_dim=256, normalize_output=False),
        refiner=RefinerConfig(zoom_crop_size=32, corr_levels=2, raster_chunk=64,
                              render_iters=R, gru_iters=G, mixed_precision=False)))
    return init_random_(model, torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def scene():
    return {B: make_synthetic_inputs(_syn(B), device="cpu", with_corr=True) for B in (1, 2)}


def _names(doc, call):
    return [s["name"] for s in doc["stamps"] if s["call"] == call]


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _tensors(out[k])]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _tensors(v)]
    return []


def test_marks_and_spans_do_nothing_without_a_tracer(scene):
    """No tracer active: `mark` records nothing, `span_on(None, ...)` is a
    no-op; the eager forward gives the same bits with a tracer active."""
    x = scene[1]
    model = _model().eval()
    tr = Tracer("cpu")
    profiling.mark("encode")
    with profiling.span_on(None, "outside"):
        pass
    assert isinstance(profiling.span_on(None, "x"), contextlib.nullcontext)
    assert tr.export()["stamps"] == [] and tr.export()["spans"] == []
    plain = model(x)
    with tr.active():
        traced = model(x)
    assert len(tr.export()["stamps"]) == len(FORWARD)
    a, b = _tensors(plain), _tensors(traced)
    assert len(a) == len(b) > 10 and all(torch.equal(u, v) for u, v in zip(a, b))


def test_stages_partition_a_forward(scene):
    """A forward's marks, closed by END, cut its timeline into
    1 + R (2 + 2 G) + 1 stages that cover it: their sum is the first stamp
    to the last."""
    tr = Tracer("cpu")
    model = _model().eval()
    with tr.call("forward"):
        model(scene[1])
        profiling.mark(END)
    doc = tr.export()
    assert _names(doc, 1) == FORWARD + [END]
    assert len(FORWARD) == 1 + R * (2 + 2 * G) + 1
    call, = doc["calls"]
    assert [n for n, _, _ in call["intervals"]] == FORWARD
    ms = profiling.stage_ms(doc)
    total = sum(v[0] for v in ms.values())
    assert total == pytest.approx((call["last_stamp_ns"] - call["first_stamp_ns"]) / 1e6,
                                  rel=1e-9)
    assert set(ms) == {"encode", "render", "flow", "pose", "tail"} and min(
        v[0] for v in ms.values()) > 0


def test_engine_spans_nest_and_share_the_call_id(scene):
    tr = Tracer("cpu")
    engine = InferenceEngine(_model().eval(), tracer=tr)
    engine.prepare("a", scene[1])
    for _ in range(2):
        engine.refine("a", scene[1])
    doc = tr.export()
    assert [c["name"] for c in doc["calls"]] == ["engine/prepare", "engine/refine",
                                                  "engine/refine"]
    spans = doc["spans"]
    assert [s["name"] for s in spans if s["call"] == 1] == ["engine/prepare", "engine/encode_3d"]
    for call in (2, 3):
        mine = [i for i, s in enumerate(spans) if s["call"] == call]
        root = mine[0]
        assert spans[root]["name"] == "engine/refine" and spans[root]["parent"] is None
        assert [spans[i]["name"] for i in mine[1:]] == [
            "engine/copy_in", "engine/replay", "engine/clone_out"]
        for i in mine[1:]:
            s = spans[i]
            assert s["parent"] == root
            assert spans[root]["start_ns"] <= s["start_ns"] <= s["end_ns"] <= spans[root]["end_ns"]
        assert _names(doc, call) == ["copy_in", END] + FORWARD + [END, "clone_out", END]
    assert {s["call"] for s in doc["stamps"]} == {2, 3}
    assert doc["stamps_expected"] == doc["stamps_launched"] == len(doc["stamps"])


def test_trainer_spans_nest_and_share_the_call_id(scene):
    tr = Tracer("cpu")
    trainer = Trainer(_model(), OptimizerConfig(), tracer=tr)
    for _ in range(2):
        trainer.run_step(scene[1])
    doc = tr.export()
    assert [c["name"] for c in doc["calls"]] == ["trainer/step"] * 2
    for call in (1, 2):
        mine = [s for s in doc["spans"] if s["call"] == call]
        assert [s["name"] for s in mine] == ["trainer/step", "trainer/copy_in",
                                             "trainer/replay_a", "trainer/all_reduce",
                                             "trainer/replay_b"]
        root = doc["spans"].index(mine[0])
        assert all(s["parent"] == root for s in mine[1:])
        assert _names(doc, call) == (["copy_in", END, "forward"] + FORWARD
                                     + ["backward", END, "update", END])
    groups = profiling.group_ms(doc, ("forward", "backward", "update"))
    stages = profiling.stage_ms(doc)
    for k in range(2):
        nested = sum(stages[n][k] for n in ("forward", "encode", "render", "flow", "pose",
                                            "tail"))
        assert groups["forward"][k] == pytest.approx(nested, rel=1e-12)
        assert groups["backward"][k] == stages["backward"][k] > 0
        assert groups["update"][k] == stages["update"][k] > 0
    assert len(profiling.span_ms(doc, "trainer/replay_a")) == 2


def test_counters_count_as_documented(scene):
    """One encode_3d per class, one program per key, a replay (the eager
    forward on the CPU) per request; the trainer's runs per key on the
    CPU; the export holds the engine's counters; no graph on the CPU."""
    tr = Tracer("cpu")
    engine = InferenceEngine(_model().eval(), tracer=tr)
    engine.prepare("a", scene[1])
    assert (engine.encode_3d_calls, engine.graph_captures, dict(engine.replays)) == (1, 1, {})
    for _ in range(3):
        engine.refine("a", scene[1])
    engine.refine("b", scene[2])
    assert engine.encode_3d_calls == 2 and engine.graph_captures == 2
    assert dict(engine.replays) == {"a:(1, 64, 64, 3)": 3, "b:(2, 64, 64, 3)": 1}
    assert engine.graph_nodes == {}
    doc = tr.export()
    assert doc["counters"] == {"engine": engine.counters()}
    assert doc["stamps_launched"] == 4 * (len(FORWARD) + 5)

    untraced = InferenceEngine(_model().eval())
    untraced.refine("a", scene[1])
    assert dict(untraced.replays) == {"a:(1, 64, 64, 3)": 1} and untraced.graph_captures == 1

    trainer = Trainer(_model(), OptimizerConfig())
    for _ in range(2):
        trainer.run_step(scene[1])
    assert trainer.graph_captures == 1 and dict(trainer.replays) == {"step:(1, 64, 64, 3)": 2}


def _span(name, start, end, parent, call):
    return {"name": name, "start_ns": start, "end_ns": end, "parent": parent, "call": call}


def _stamp(call, name, ns, replay=False):
    return {"call": call, "name": name, "replay": replay, "device_ns": ns + 1000, "ns": ns}


def test_idle_attribution_on_a_synthetic_timeline():
    """Entry idle runs from the later of the call's entry and the previous
    call's last stamp to the first stamp; every interval after an END stamp
    is a wait; each is named by the innermost host span open at its start."""
    doc = {
        "spans": [_span("call", 0, 100, None, 1), _span("copy", 5, 20, 0, 1),
                  _span("replay", 20, 40, 0, 1),
                  _span("call", 110, 155, None, 2), _span("copy", 112, 118, 3, 2),
                  _span("replay", 118, 125, 3, 2)],
        "stamps": [_stamp(1, "copy_in", 10), _stamp(1, END, 15),
                   _stamp(1, "encode", 30, True), _stamp(1, "tail", 60, True),
                   _stamp(1, END, 130, True),
                   _stamp(2, "copy_in", 150), _stamp(2, END, 160),
                   _stamp(2, "encode", 170, True), _stamp(2, END, 190, True)],
    }
    doc["calls"] = profiling._calls(doc)
    idle = doc["idle"] = profiling._idle(doc)
    got = [(i["call"], i["kind"], i["start_ns"], i["ns"], i["span"]) for i in idle]
    assert got == [(1, "entry", 0, 10, "call"), (1, "wait", 15, 15, "copy"),
                   (2, "entry", 130, 20, "call"), (2, "wait", 160, 10, "(no span)")]
    assert profiling.idle_ms(doc) == pytest.approx({"call": 30e-6, "copy": 15e-6,
                                                    "(no span)": 10e-6})
    assert [c["replay_ns"] for c in doc["calls"]] == [100, 20]
    assert profiling.stage_ms(doc) == {"copy_in": pytest.approx([5e-6, 10e-6]),
                                       "encode": pytest.approx([30e-6, 20e-6]),
                                       "tail": pytest.approx([70e-6, 0.0])}
    assert profiling.self_ms(doc) == pytest.approx(
        {"call": (65 + 32) / 1e6, "copy": 21 / 1e6, "replay": 27 / 1e6})


def test_calibration_on_synthetic_pairs():
    """The pair with the shortest round trip sets the offset (at its middle)
    and the error bound (half of it); two calibrations give the drift, and
    `to_host` maps the device clock onto the host's."""
    start = profiling.calibrate([(0, 5000, 400), (1000, 6150, 1100), (2000, 7000, 2600)])
    assert start == {"offset_ns": 6150 - 1050, "error_ns": 50, "device_ns": 6150, "pairs": 3}
    end = profiling.calibrate([(1_000_000, 1_005_200, 1_000_020)])
    clock = profiling.clock_fit(start, end)
    assert clock["drift"] == pytest.approx((5190 - 5100) / (1_005_200 - 6150))
    assert clock["error_ns"] == 50
    assert profiling.to_host(6150, clock) == pytest.approx(1050)
    assert profiling.to_host(1_005_200, clock) == pytest.approx(1_000_010)


def test_export_round_trip(scene, tmp_path):
    """`export(path)` writes the document it returns; its readers give the
    same numbers on the JSON read back; `report` names the stages."""
    tr = Tracer("cpu")
    engine = InferenceEngine(_model().eval(), tracer=tr)
    engine.refine("a", scene[1])
    path = tmp_path / "trace.json"
    doc = tr.export(str(path))
    with open(path) as f:
        back = json.load(f)
    assert back == json.loads(json.dumps(doc))
    assert profiling.stage_ms(back) == profiling.stage_ms(doc)
    assert profiling.idle_ms(back) == profiling.idle_ms(doc)
    assert profiling.self_ms(back) == profiling.self_ms(doc)
    text = profiling.report(back)
    for name in ("encode", "render", "flow", "pose", "tail", "engine/replay", "clock"):
        assert name in text
    assert back["clock"]["error_ns"] >= 0 and back["stamps_mismatched"] == 0


def test_span_is_a_record_function_under_the_profiler(tmp_path):
    tr = Tracer("cpu")
    with profiling.trace(str(tmp_path / "t")) as prof:
        with tr.call("outer"), tr.span("inner"):
            torch.ones(4).add_(1)
    assert {"outer", "inner"} <= profiling.annotation_names(prof)
    assert [s["name"] for s in tr.export()["spans"]] == ["outer", "inner"]
