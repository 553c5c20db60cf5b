"""What the rooflines and `step_mfu` divide by: the bytes and operations
the algorithm must move and do, counted from the configuration's shapes
(the reference's tables), and the card's published peaks."""
