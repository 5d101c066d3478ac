"""Networks of the eval forward and the weight bridge."""
