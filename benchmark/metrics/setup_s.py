"""Seconds from the process's start to the end of the program's set-up:
imports, the CUDA context, the kernels' libraries, the inputs and the
warm-up. Left out: the reference's cache build (a checkout's first run)
and the profiler's start before the window, both the benchmark's own."""


def read(o):
    return o.setup_s or None
