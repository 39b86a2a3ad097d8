"""The LSTM encoder, model specs and the weight converter."""
