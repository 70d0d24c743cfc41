"""Pytest settings for the whole checkout, loaded before ``tests/conftest.py``.

Hypothesis keeps its storage (the example database and a unicode-category
cache) in ``.hypothesis/`` unless ``HYPOTHESIS_STORAGE_DIRECTORY`` names
another directory; it reads the variable at its first storage access, not
at import.  ``.hypothesis/`` holds tracked files that a test run would
otherwise rewrite, so the storage goes to the ignored ``build/hypothesis/``
of this checkout unless the caller chose a directory."""
import os
from pathlib import Path

os.environ.setdefault("HYPOTHESIS_STORAGE_DIRECTORY",
                      str(Path(__file__).resolve().parent / "build" / "hypothesis"))
