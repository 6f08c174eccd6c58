"""Host geometry stage: SVG -> attributed graph -> proposals (numpy)."""
