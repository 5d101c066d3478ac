"""Host-side native ops: a ctypes loader for `rnnpose_tpu/cpp/native_ops.cpp`."""
