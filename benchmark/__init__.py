"""The benchmark of pocketsphinx_tpu_torch on one NVIDIA H100: see
`run.py` and `BENCHMARK.json` at the root of the checkout."""
