"""Mixture-of-experts gating (with its balance loss) and dispatch."""
