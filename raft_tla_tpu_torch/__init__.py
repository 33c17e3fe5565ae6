"""PyTorch/CUDA port of the raft_tla_tpu exhaustive model checker.

The JAX package ``raft_tla_tpu`` is the reference; this package imports
nothing of it (nor ``jax``) and keeps its own copies of what it needs.
Entry points: ``engine.check.run_check`` / ``make_engine`` and
``python3 -m raft_tla_tpu_torch check <cfg>``, on the card unless the
caller passes ``device="cpu"``.
"""
