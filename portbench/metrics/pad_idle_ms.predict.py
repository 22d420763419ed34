"""``pad_idle_ms.predict``: the card's idle time inside the program's
``hcunet.serve.bucket_pad`` span (``Segmenter.predict``'s host ``np.pad`` to
the bucket and the float32 array made from it), in ms a request of the
traced window."""

from portbench.spans import idle_ms_per_request


def read(obs):
    return idle_ms_per_request(obs, "hcunet.serve.bucket_pad")
