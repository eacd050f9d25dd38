"""Transforms, transform families, the ACDC layer and SELL dispatch
(port of :mod:`repro.core`), with the reference's package-level names.

As in the reference, the single-layer function ``acdc.acdc`` is not
re-exported here: it would shadow the ``acdc`` submodule.
"""

from repro_torch.core.acdc import (  # noqa: F401
    ACDCConfig,
    acdc_cascade,
    acdc_cascade_dense_equivalent,
    acdc_rectangular,
    init_acdc_params,
)
from repro_torch.core.families import (  # noqa: F401
    TransformFamily,
    get_family,
)
from repro_torch.core.sell import (  # noqa: F401
    SellConfig,
    init_sell_params,
    sell_dense_equivalent,
    structured_linear,
)
