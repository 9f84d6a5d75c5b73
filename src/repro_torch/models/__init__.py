"""Model code of the port: every LM family's serving path (dense, MoE and
MLA, audio, vision, Mamba2 "ssm", hybrid), the training loss, and the
expert-parallel MoE."""
