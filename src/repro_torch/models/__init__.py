"""The paper's CNN and the dense transformer stack with its serve path;
the other transformer families wait for ROADMAP.md Queue 1 item 9."""
from . import cnn
