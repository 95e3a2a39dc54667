"""Host-side helpers: natural sort, score tables, stage timing, overlays."""
