"""Analytic step models and HLO text analysis for the LM dry run."""
