"""Operation and byte counts from shapes, and the card's published peaks."""
