"""Input pipeline: the depth-N device prefetcher."""
