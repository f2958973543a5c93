"""The device feed: stacked, prefetched batches on the card."""
