"""The benchmark's harness: the cell's files (``manifest``), the inputs made
from the seed (``inputs``), the program under test (``program``), one run
(``session``), ranks of a data-parallel cell (``launch``), the profiler's
trace (``trace``), the work counts and peaks (``work``) and the comparison
that decides ``correct`` (``judge``)."""
