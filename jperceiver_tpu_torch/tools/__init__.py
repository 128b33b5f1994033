"""Command-line tools of the port: train, eval_depth, draw_odometry,
acceptance, plot_trajectory, make_splits and video_demo."""
