"""The paper's CNN, and the transformer stack of every family in
``repro_torch.configs`` (dense, MoE, SSM, hybrid, the vision prefix and
the encoder-decoder) with its serve path."""
from . import cnn
