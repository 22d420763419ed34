"""``mfu_pct.predict``: the model's FLOPs for the volumes ``Segmenter.predict``
served over the window (their own voxels, not their buckets') times the
compute dtype's peak."""

from portbench.readers import mfu_pct


def read(obs):
    return mfu_pct(obs)
