"""AlexNet conv config — the paper's own Table-1 subject (not an LM arch).

The layout lives in ``repro_torch.models.cnn.ALEXNET_LAYOUT`` and the MOA
census in ``repro_torch.core.dhm.ALEXNET_CONV_SPECS``.
"""

from repro_torch.core.dhm import ALEXNET_CONV_SPECS, ALEXNET_PAPER_NOPD
from repro_torch.models.cnn import (ALEXNET_LAYOUT, alexnet_forward,
                                    init_alexnet)

NAME = "alexnet"
INPUT_SHAPE = (227, 227, 3)
