"""setup_s: seconds from the start of set-up (data generation) to the end
of the warm-up, on the host clock."""


def read(m):
    return m["setup_s"]
