"""Batch verification over the port's backends: `parallel.batch_verify`
(the JAX package's `parallel/`; its mesh-sharded MSM and multi-host layer
are a later slice).
"""
