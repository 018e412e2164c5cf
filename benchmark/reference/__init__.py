"""The benchmark's plain references: independent PyTorch versions of what the
program computes, which decide whether a run is correct."""
