"""No-op phase spans: the copy is timed from outside."""

import contextlib


@contextlib.contextmanager
def span(name: str):
    yield
