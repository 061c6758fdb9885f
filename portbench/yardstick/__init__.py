"""What the benchmark measures with: the card's peaks, the operation and
byte counts, the profiler's reading, spans, weights and inputs drawn
from the seed. Frozen here so that a change to the program cannot move
the yardstick."""
