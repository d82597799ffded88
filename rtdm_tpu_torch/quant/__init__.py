"""int8 quantization: QDQ of weights and activations, and calibration."""
