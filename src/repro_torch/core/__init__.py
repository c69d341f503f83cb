"""Allocation core: service sets, the intra-service solve, DISBA, policies."""
