"""Greedy decoding (eager oracle) and host-side post-processing."""
