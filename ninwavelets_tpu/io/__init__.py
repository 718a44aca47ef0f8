"""File IO subsystem: native (C++) window gathers, EDF reader/writer,
prefetching stream sources.

The reference has no IO layer (in-memory numpy only); this package is
this build's data loader — mmap'd recordings, GIL-free native
gathers, and double-buffered streaming into the device compute path.
"""
from .bdf import BDFRaw, BDFReader, status_events, write_bdf
from .brainvision import (BVRaw, BVReader, BVSource,
                          read_markers, write_brainvision)
from .edf import EDFRaw, EDFReader, write_edf
from .native import native_available
from .stream import ArraySource, EDFSource, iter_ext_batches

__all__ = ["EDFReader", "EDFRaw", "write_edf", "native_available",
           "ArraySource", "EDFSource", "iter_ext_batches",
           "BVReader", "BVRaw", "BVSource", "read_markers",
           "write_brainvision",
           "BDFReader", "BDFRaw", "write_bdf", "status_events"]
