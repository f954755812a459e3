"""Model assembly: norms/rope/projections, attention, FFN, the decoder-only
LM, and the unified init/serve API."""
