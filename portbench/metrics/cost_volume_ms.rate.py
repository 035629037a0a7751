"""Device milliseconds a frame of the operations launched inside the
plain stages that build cost volumes: the census transform and its Hamming
volume, the seed volume of a rectified pair and the running mean of a posed
view."""

UNIT = "ms/frame"
LAYER = "Plain stages (stereo/census.py, stereo/costvolume.py)"
MOVES = "frames_per_s"
RANGES = {
    "stereo.census.census": "stereo.census:census",
    "stereo.census.census_cost_volume": "stereo.census:census_cost_volume",
    "stereo.costvolume.cost_volume_from_stereo": "stereo.costvolume:cost_volume_from_stereo",
    "stereo.costvolume.cost_volume_add": "stereo.costvolume:cost_volume_add",
}


def read(run):
    t = run.trace
    dev = t.device_s(RANGES) if t is not None and t.frames else 0.0
    if not dev:
        return None
    return dev * 1e3 / t.frames
