"""Host-side native code of the port: the C++ OBJ reader and chart unwrap
(`objio`), the counterpart of contexture_nerf_tpu/native/."""
