"""The benchmark's frozen arithmetic: operations and bytes from shapes,
and the card's published peaks."""
