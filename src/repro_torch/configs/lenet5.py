"""LeNet-5 conv config — the paper's ×8.6 SCM-optimization subject ([1])."""

from repro_torch.core.dhm import LENET5_CONV_SPECS
from repro_torch.models.cnn import LENET5_LAYOUT, init_lenet5, lenet5_forward

NAME = "lenet5"
INPUT_SHAPE = (32, 32, 1)
