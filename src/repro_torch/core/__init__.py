"""Chimbuko core for the PyTorch port.

Submodules:
  events      trace event schema (copy of repro.core.events)
  stats       Pébay one-pass moments, float64 host oracle (copy)
  callstack   vectorized call-stack builder (copy)
  ad          on-node AD module, SSTD μ±6σ and HBOS (copy)
  ps          online AD parameter server (copy; no socket transport or WAL)
  reduction   anomaly-based data reduction (copy)
  provenance  prescriptive provenance DB (copy; records torch, not jax)
  sim         synthetic workloads with ground truth (copy)
  torch_ad    on-device distributed AD (PS merge as all-reduces)
"""
