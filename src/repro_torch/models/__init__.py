"""The model stack of the port: configs, layers, attention, the decoder
LM of every decoder-only family, the encoder-decoder (``encdec``) and the
registry."""
