"""Frozen operation and byte counts, and the card's peaks, for the
roofline and MFU readers."""
