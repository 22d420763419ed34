"""``hcat.main``: the reference's pipeline module, as its batch driver
imports it (``from hcat.main import analyze``).

:func:`analyze` is the facade's, the same object as the package's
top-level ``analyze``, ``./all_cells.pkl`` side effect included.
"""

from hcunet_tpu_torch.compat import analyze  # noqa: F401

__all__ = ["analyze"]
