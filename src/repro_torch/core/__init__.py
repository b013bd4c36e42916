"""Scheduling and placement: AEBS, replica layouts, routing traces."""
