"""Chimbuko core for the PyTorch port.

Submodules:
  events      trace event schema (copy of repro.core.events)
  stats       Pébay one-pass moments, float64 host oracle (copy)
  callstack   vectorized call-stack builder (copy)
  sim         synthetic workloads with ground truth (copy)
  torch_ad    on-device distributed AD (PS merge as all-reduces)
"""
