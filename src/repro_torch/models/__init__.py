"""The paper's CNN; the transformer models wait for ROADMAP.md Queue 1
item 9."""
from . import cnn
