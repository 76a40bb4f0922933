def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips, with its reason, where there is none")
