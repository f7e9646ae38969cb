"""The LM stack of the port: layers, the block kinds (MoE, RG-LRU, mLSTM and
sLSTM), the decoder-only LM, the encoder-decoder, the model facade and the
analytic FLOP model."""
