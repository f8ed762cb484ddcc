"""setup_s: seconds from the process's start to the window's: the CUDA
context, drawing the weights, building the server, capturing its step
graph (and a checkout's first build of the decode kernel), the mix's
warm-up steps."""


def read(run):
    return run.setup_s
