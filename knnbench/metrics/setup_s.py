"""setup_s: seconds from the process's start to the first timed batch or
request (the driver's host clock): loading the extension, making the
data, building the index and warming up the cell's shapes."""


def read(run):
    return run.setup_s
