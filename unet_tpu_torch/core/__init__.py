"""Multi-process runtime: the process group and the data-parallel
layout of ranks over devices."""
