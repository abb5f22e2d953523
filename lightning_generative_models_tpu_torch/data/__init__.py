"""Datasets (numpy), the DataModule and the host-to-device prefetcher."""
