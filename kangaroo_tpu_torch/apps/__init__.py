"""Applications: the SGM and DTAM stereo frames, KinectFusion, and synthetic input."""
