"""Traffic models, mapping policies, online learning, prefetcher state,
queuing-network and device behavioral models."""
