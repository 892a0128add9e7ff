"""Host-side skeleton data: pre-normalization and modality derivation."""
