import jax

# Smoke tests and benches must see ONE device (the dry-run sets its own
# XLA_FLAGS in-module and runs via subprocess) — never force device counts
# here (per the brief).
jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
    # real-engine HTTP serving tests (compile + network round-trips): CI
    # runs them in their own shard (`-m http`) and keeps the main matrix
    # at `-m "not http"`; plain `pytest` still collects everything
    config.addinivalue_line(
        "markers", "http: end-to-end HTTP serving tests over a real engine")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skips without one")

