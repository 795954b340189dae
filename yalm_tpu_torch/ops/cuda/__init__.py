"""Hand-written Hopper kernels (csrc/) behind device-dispatching wrappers."""
