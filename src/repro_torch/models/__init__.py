"""Model code: attention, MoE and the decoder stack for the ported families."""
