"""pytest settings of the benchmark's own tests: the `card` marker names the
tests that need a CUDA card; each decides inside itself whether one is
present and skips otherwise."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
