"""repro_torch: Chimbuko's on-device anomaly detection in PyTorch and CUDA.

The PyTorch counterpart of ``repro``, laid out like it so that each module
has a twin of the same name:

  core/       host trace model (events, stats, callstack, sim), the
              monitor's AD, PS, provenance and offline replay, and the
              device-side AD step with its collectives (torch_ad)
  trace/, telemetry/, net/, fault/, export/, viz/, lint/
              the monitor, its shard federation over sockets with crash
              recovery and the trace export (host modules copied from
              ``repro``: numpy and the standard library only)
  launch/     the step builders (train, data-parallel, the dry run's
              cells), the serving and training drivers, the roofline
              model and the dry run, the sharding rules, and the shard
              worker launcher (``shard_server``, torch-free)
  compat      the dry run's counting context (FLOPs, bytes, live memory,
              collectives) and ``make_mesh``
  kernels/    the hand-written Hopper kernels, their plain PyTorch versions
              and the wrappers that dispatch between them
  convert     stats tables carried between the JAX package, the host
              ``StatsTable`` and this package
  device      the default device (CUDA, never a silent CPU) and parity mode

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.  Entry points run on ``cuda:0`` unless the caller passes
``device="cpu"``; kernel wrappers take their plain version only for tensors
that lie on the CPU.
"""
