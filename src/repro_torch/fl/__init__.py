"""Multi-period FL simulation on top of the allocation core."""
