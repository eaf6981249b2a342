"""The benchmark of plonkathon_tpu_torch: see BENCHMARK.json and PERF.md."""
