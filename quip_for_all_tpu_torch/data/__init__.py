"""Token sources for calibration and fine-tuning."""
