"""Reader runtime (counterpart of paddle_tpu/reader/): the py_reader
queue and its device prefetch (pipeline.py)."""
from .pipeline import PyReader, get_reader, EOFException  # noqa: F401
