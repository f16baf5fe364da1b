"""RecordIO writer entry points (counterpart of paddle_tpu/recordio_writer.py;
reference python/paddle/fluid/recordio_writer.py). The engine lives in
recordio.py; this module keeps the reference's import path."""
from .recordio import (convert_reader_to_recordio_file,    # noqa: F401
                       convert_reader_to_recordio_files,   # noqa: F401
                       RecordIOWriter, Compressor)         # noqa: F401

__all__ = ['convert_reader_to_recordio_file',
           'convert_reader_to_recordio_files']
