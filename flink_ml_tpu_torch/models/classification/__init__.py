"""Classification estimators and models."""
