"""The model stack of the port: configs, layers, attention, the decoder
LM and the registry (the dense family; the other families come with
their slices, ROADMAP.md)."""
