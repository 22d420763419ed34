"""The reference's ``hcat`` package on the port (twin of the repository's
``hcat/`` alias, which stays bound to the JAX package).

The reference is driven as ``from hcat import unet, rcnn, analyze`` and
through its submodules (``from hcat.main import analyze``, ``import
hcat.train``, ``from hcat.r_unet import RecursiveUnet``, ...).  This package
gives the same names, signatures and channels-first array layout, run by
:mod:`hcunet_tpu_torch` on CUDA unless the caller names another device.  A
reference driver reaches it by replacing its ``hcat`` prefix with
``hcunet_tpu_torch.hcat``::

    from hcat.main import analyze              # the JAX alias
    from hcunet_tpu_torch.hcat.main import analyze   # the port

The top level re-exports :mod:`hcunet_tpu_torch.compat` (its ``__all__``
and the module constants, ``__conectivity__`` among them).  The literal
top-level name ``hcat`` is not rebound: no import hook, no ``sys.modules``
alias.
"""

from hcunet_tpu_torch.compat import *  # noqa: F401,F403
from hcunet_tpu_torch.compat import __all__  # noqa: F401

# Import the submodules eagerly, THEN rebind the two names where a
# submodule and a facade object collide: ``unet`` and ``rcnn`` are the
# class and the factory at the top level, as in the reference's ``from hcat
# import unet, rcnn``; ``import hcunet_tpu_torch.hcat.unet`` still resolves
# the module, which is already in ``sys.modules``.
from hcunet_tpu_torch.hcat import (  # noqa: F401,E402
    dataloader,
    haircell,
    loss,
    main,
    mask,
    r_unet,
    rcnn,
    segment,
    train,
    transforms,
    unet,
    utils,
    validate,
)
from hcunet_tpu_torch.compat import rcnn, unet  # noqa: F401,F811,E402
