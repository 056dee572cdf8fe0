"""Runtime helpers of the port (the divergence sentinel)."""
