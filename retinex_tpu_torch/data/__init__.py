"""Host-side input: image listing and decode."""
