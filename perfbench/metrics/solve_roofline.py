"""solve_roofline: the least time of one batch's whole solve on an H100
(`perfbench.work`, from the problem alone) over the device time of every
kernel the solve launched (CUDA events behind a spin kernel), in percent."""


def read(m):
    s = m.get("solve")
    if not s or s["device_s"] <= 0:
        return None
    return 100.0 * s["least_s"] / s["device_s"]
