"""The CNN-LSTM model as torch modules."""
