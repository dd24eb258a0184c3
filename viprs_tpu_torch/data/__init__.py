"""Datasets: summary statistics with block-packed LD."""
