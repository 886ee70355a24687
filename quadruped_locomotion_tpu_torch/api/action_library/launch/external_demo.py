"""Launch-type action payload: an external process (≙ LaunchAction's
roslaunch child). Exits 0 after announcing itself."""

print("external process action ran")
