"""Helpers of the port that several modules share."""
