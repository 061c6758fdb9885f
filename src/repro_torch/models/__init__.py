"""The paper's CNN, and the transformer stack (the dense, SSM and hybrid
layer types) with its serve path; the other transformer families wait
for ROADMAP.md Queue 1 item 9."""
from . import cnn
