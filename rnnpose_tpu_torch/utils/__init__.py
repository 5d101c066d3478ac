"""Host utilities: experiment-config I/O and a progress bar."""
