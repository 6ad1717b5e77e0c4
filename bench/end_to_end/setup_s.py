"""setup_s: seconds from the process's start to the window's: imports,
loading or building the kernels, making the inputs and the weights,
planning and warming every shape the cell uses."""


def value(run):
    return run["setup_s"]
