"""Core: allocation, plan compile, fused coded Shuffle and the engine."""
