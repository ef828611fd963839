"""Volume and slice data helpers of the port (numpy)."""
