"""Simulator core: masks, importance, pruned rates, timing, aggregation, workers, fleet."""
