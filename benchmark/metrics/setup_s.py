"""Set-up seconds: process start to the window's start in a training
cell (imports, the kernels' build or load, weights, the train state, the
checked first steps), to the first request of the mix in a serving cell
(imports, kernels, weights, the engine, one request through each step
shape).  A serving cell's ramp, a fixed span of the mix's arrival clock
that no change of the program lengthens or shortens, is left out."""


def read(ctx):
    return ctx["setup_s"]
