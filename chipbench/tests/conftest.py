"""The benchmark's tests: CPU tests at smoke size, and ``cuda`` tests that
run only on the card and decide so inside the test."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (Hopper) and nvcc; skips without")
