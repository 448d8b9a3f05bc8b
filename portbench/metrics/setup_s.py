"""setup_s: process start to the first timed call, by the host's clock
(CUDA start, the kernel library's build or load, the scene's generation,
load and flatten, the traffic's warm-up calls)."""


def read(r):
    return r.setup_s
