"""fps: decoded pictures synchronised on the device over the window's wall
time (every picture and all the time of the window)."""
from gbench import stats


def read(run):
    return stats.rate(run.window.pictures, run.window.wall_s)
