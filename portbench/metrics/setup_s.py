"""setup_s: the process's set-up up to the first timed call, on the host
clock: importing PyTorch and the program, initialising CUDA, building
(first run in a checkout) or loading the kernels and the host library,
making the clip, and one untimed round trip of its first frames."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
