"""The planner's map queries: top-down occupancy (topdown), panorama
invisibility (panorama) and the host-side hole scoring (clusters)."""
