"""The yardstick of the port's benchmark: what `portbench/run.py` uses to
make traffic, drive the port, trace it, count kernels' work and decide
`correct`.  Nothing here imports `jax` or `av1dec_tpu`; the port
(`av1dec_tpu_torch`) is imported only by `drive`, `spans`, `trace` and
`work`, inside functions."""
