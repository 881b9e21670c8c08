"""The marker of tests that need a CUDA card, ``card``. Each such test
decides in a fixture whether there is a card and skips without one; run
them on the card with ``python -m pytest -q -m card tests``."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
