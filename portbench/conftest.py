"""The benchmark's tests: the `cuda` marker of the repository's tests
(a test that needs a card skips itself without one)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; the test skips itself "
        "when none is present")
