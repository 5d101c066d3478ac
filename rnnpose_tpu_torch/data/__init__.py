"""Host-side data: pose sampling and the synthetic scene."""
