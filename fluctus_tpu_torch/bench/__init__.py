"""The user's benchmark harness (the reference package's bench/): the
fixed protocol and ``.bm.json`` files."""

from .harness import run_benchmark, run_benchmark_file  # noqa: F401
