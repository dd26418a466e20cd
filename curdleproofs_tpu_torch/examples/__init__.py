"""Runnable walkthroughs of the port (the JAX package's `examples/`), each
`python3 -m curdleproofs_tpu_torch.examples.<name>`:

- `whisk_ssle_demo`: the Whisk SSLE walkthrough at l = 124;
- `chain_sync_demo`: chain-sync batch verification of shuffle and tracker
  proofs;
- `msm_demo`: resident bases, a warm `msm_device`, then `sharded_msm` on a
  grid of devices.

Each runs on the card by default and raises without one: the protocol
demos on the active backend (`CURDLEPROOFS_BACKEND=host` runs them on the
CPU), the MSM demo on `--device` (`--device cpu` runs the kernels' plain
versions).  Each `main(argv)` also runs in-process.
"""
