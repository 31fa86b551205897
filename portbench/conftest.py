"""Pytest settings of the benchmark's own tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")
