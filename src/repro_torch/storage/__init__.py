"""Two-tier storage substrate: tier-1 cache engine and tier-2 simulator."""
