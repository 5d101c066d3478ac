"""Host utilities: experiment-config I/O."""
