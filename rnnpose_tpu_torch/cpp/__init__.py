"""Host-side native ops: a ctypes loader for the port's `csrc/native_ops.cpp`."""
