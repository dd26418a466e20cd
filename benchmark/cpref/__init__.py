"""The benchmark's plain reference and input maker.

The Curdleproofs and Whisk protocol on plain host arithmetic: the fields
and the curve on Python ints, the STROBE transcript, ChaCha12 `StdRng`,
the codecs, and `host/plain.c` for the heavy point arithmetic (one
bucket-method MSM, double-and-add scalar multiplications, the two
permutations), built into `benchmark/_build/`.  Held bit-exact against the
Rust reference's golden proof by `benchmark/tests/test_bench_reference.py`.
It imports nothing of the program and nothing of JAX.
"""
