"""Bring-up check of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py [--seed N] [--steps N] [--material-steps N]
                          [--transient-steps N] [--transient-material-steps N]
                          [--trainer-steps N] [--profile FILE]

Phases, one line each (any failure exits nonzero):
  1. device: the card, and nvidia-smi's name and power limit;
  2. build: compile the CUDA source from csrc/ with nvcc, and beside it the
     JPEG entropy decoder's C source with the host C compiler;
  3. kernel: the leveled kernel against its plain PyTorch version at the
     flagship cache shape (6 levels x 262,144 points x 4 taps, F = 4,
     524,288 rows), on uniform points and on camera-ray samples;
  4. kernel (planes): the planes kernel against its plain version at the
     flagship material shape (6 levels x 1,572,864 secondary-ray samples x
     4 taps), with the leveled kernel checked and timed on the same updates,
     and each level's slice timed alone;
  5. kernel (rows): the row scatter against its plain version on the
     run-deduplicated update stream of the flagship cache shape (camera-ray
     samples, 6 x 1,048,576 updates), and its padded wrapper at a ragged
     update count; timed against index_add_ there and on the same updates
     before the dedup scan, beside the skip instance on the dedup'd stream
     and the host time of one call;
  6. encoder: hash-grid table gradients, kernel backward against the plain
     backward, at the cache shape (leveled) and the material shape (planes);
  7. reference: a narrow cache model with the flagship's structure, the same
     weights on the GPU and on the CPU (whose path the CPU tests hold
     against the JAX package), loss and gradients compared; the gradient
     limit is checked against a noise floor and two planted scatter faults;
  8. material reference: the same for a narrow material model, with the
     same random draws on both devices, the secondary-ray encoder on the
     planes kernel, and the faults planted in the planes kernel;
  9. transient reference: the same for a narrow transient cache model, once
     with the direct table-gradient scatter and once with its run-dedup (the
     faults planted in the leveled kernel and in its skip instance); the
     dedup and direct table gradients on the card agree to float32 order;
 10. train: the full-width flagship cache model, batch 8192 on
     SyntheticSpheres (8 views, 128^2): 3 warmup + N timed steps; losses
     finite, every parameter the passive shader reads changed, one kernel
     launch per step;
 11. material train: the full-width flagship material model, batch 1536 on
     the same scene: first one step in which every scatter call is held
     against its plain version on the same inputs (both kernels at the
     shapes this path gives them), whose planes inputs then time the planes
     kernel against index_add_ (all levels and each level alone), then 3
     warmup + N timed steps with
     gradient checkpointing
     (the JAX setting), then one step without it for its peak memory;
     losses finite, exactly the parameters no loss reaches unchanged, the
     per-step launch counts of both kernels as the model's structure gives;
 12. transient train: the full-width flagship transient cache model, batch
     2048 x 700 bins on SyntheticSpheres (4 views, 64^2), with the direct
     backward and with scatter_dedup: one checked step each, then 3 warmup
     and N timed steps each in alternating blocks; losses finite, exactly the
     parameters no loss reaches unchanged, the pinned per-step launches,
     peak memory; then one forward + backward of the transient rendering at
     [2048, 32, 700, 3] for each shift form;
 13. kernel (skip): the skip-zero-weight instance against its plain version
     on the dedup'd stream of the transient path's own updates (captured in
     phase 12's checked step), with NaN rows planted under the zero weights,
     the share of zero-weight updates, and both scatter routes timed; then
     the leveled kernel against index_add_ on the same captured updates (all
     levels and each level alone);
 14. eval reference: the narrow cache, material and transient models of
     phases 7-9 (every parameter drawn from U(-0.5, 0.5)), the same weights and
     draws on the GPU and the CPU, render a held-out 16^2 view through
     create_render_fn + render_image in chunks of 96 (the last one ragged)
     with 2 repeats; every output compared in relative L2 against a limit
     bracketed by a CPU noise floor and two encoder faults planted in the GPU
     forward; no scatter launched;
 15. gate: the full-width flagship cache model, fresh, trained 200 steps at
     the gate's learning rate (batch 8192, 8 views at 128^2), then view 0 of
     the held-out 64^2 set rendered and scored; below 20 dB the run fails;
     200 leveled launches;
 16. eval render: bench_eval_render (full extras and rgb-only) of the
     full-width cache model on the 128^2 test view (3 timed images), of the
     material model on a held-out 64^2 view (chunks of 1024, then the whole
     view as one chunk if it fits), of the transient cache model on a
     held-out 64^2 view (one chunk of 4096 rays x 700 bins) and of the
     transient material model on that view (chunks of 1024; 2 timed images
     each): times, the render function's device time, peak memory, raw
     outputs finite, no scatter launched;
 17. transient material reference: a narrow transient material model with
     the flagship's structure (64 bins, the learnable light, 32 secondary
     rays through the transient cache), the same weights and draws on the GPU
     and the CPU, one step under the trainer's consistency binding: every
     loss term (the consistency term included) and every gradient leaf
     compared, the limit bracketed by a noise floor and two faults planted in
     the leveled kernel;
 18. transient material train: the full-width flagship transient material
     model, batch 512 x 700 bins on SyntheticSpheres (4 views, 64^2), in two
     forms (the JAX bench's step with no extra loss, and the staged trainer's
     consistency binding): one checked step each, then 3 warmup and N timed
     steps each with gradient checkpointing in alternating blocks, then one
     step each without it for its peak memory; losses finite, exactly the
     parameters no loss reaches unchanged, 3 leveled launches per step and
     no planes launch;
 19. trainer reference: the staged trainer (engine/trainer.Trainer) on
     configs/synthetic_spheres.gin, cache stage, the same weights, batch and
     draws on the GPU and the CPU, one step: every loss term (the cache_
     duplicates of the cache-only material model included) and every
     gradient leaf, the limit bracketed by a noise floor and two faults
     planted in the leveled kernel; one leveled launch;
 20. trainer train: the train_with_trainer entry point, in-process, on the
     full-width configs/ngp_yobo.gin cache stage (batch 8192 on
     SyntheticSpheres, density normals, the power-ladder ray warp, the mask
     loss, per-module schedules) into a temporary checkpoint_dir: 3 warmup
     + N timed steps by host clock ending in a sync, beside the rays/s of
     the trainer's own train_log.jsonl; losses finite with their cache_
     duplicates, the checkpoint written, a second run resumes and takes no
     step, no kernel launch (the density normals take the plain encoder),
     peak memory; then one 48^2 test view through log_test_set_evaluation;
 21. trainer material reference: phase 19's method on the material stage of
     configs/synthetic_spheres.gin (material_light_from_scratch with
     resampling, the smoothness, consistency and secondary-ray interlevel
     weights and the secondary rays' stop-gradient weights bound): every
     loss term (light_sampling, material_ray_sampler, material_smoothness,
     direct_indirect_consistency, the data terms and their cache_
     duplicates) and every gradient leaf, the limit bracketed by a noise
     floor and two faults planted in the leveled kernel; 4 leveled launches
     per step (the cache's primary and secondary samples, material
     smoothness's re-evaluation of the final density MLP, the light
     sampler's grid); then the same step with the hotdog's orientation
     loss: every loss term, the leaves whose noise floor is under a tenth of
     the limit against it and the two faults, the final density MLP's
     leaves (which the loss makes chaotic under the 1e2 secondary-ray
     weight) finite;
 22. trainer material train: the README's second stage as
     train_one_stage.py builds it (material_light_from_scratch_resample,
     sample factor 8, batch 1024, render chunk 1024) on the full-width
     configs/ngp_yobo.gin through train_with_trainer, in-process,
     warm-started from phase 20's checkpoint: 3 warmup + N timed steps,
     every loss term finite and present, no kernel launch, peak memory, the
     checkpoint written, a second run (without the warm start) that
     resumes it and takes no step, one 48^2 test view;
 23. trainer transient reference: phase 19's method on InvProp's cache
     stage (configs/transient_simulation_ngp_yobo_cornell.gin, reference
     widths, 64 bins, batch 64) with the finetune stages' occlusion
     bindings: Pixels batches cast in the step, shadow rays, the appearance
     grid, the density-grid regularizer, geometry smoothness; every loss
     term and every gradient leaf, the limit bracketed by a CPU noise floor
     (the cameras' positions one ulp up and down) and two faults planted in
     the leveled kernel; 1 leveled launch per step, held against its plain
     version on the same inputs;
 24. trainer transient train: that stage at full width (700 bins, three grid
     proposal levels, the 8-level appearance grid) through the
     train_with_trainer entry point, in-process, at the largest of batch
     8192, 4096, ... that fits (the cut printed): 3 warmup + N timed steps,
     every loss term finite and present, one leveled launch per step, peak
     memory, the checkpoint, a resuming second run that takes no step, one
     48^2 test view cast on the host; then one step with the occlusion
     bindings (shadow rays at full width) with its leveled call held against
     its plain version, the next step's time and peak memory, and the
     kernel timed against index_add_ on that call's inputs.
 25. trainer transient material reference: phase 23's method on cornell's
     material_light_from_scratch stage at reference widths (the shared
     light power on the secondary queries, shadow_eps_indirect, the stage's
     extra losses), without and with the occlusion bindings (shadow rays
     from the primary samples, the surface points and the secondary
     queries): every loss term and every gradient leaf, each limit
     bracketed by its own noise floor and two planted faults; 6 leveled
     launches per step, each held against its plain version;
 26. trainer transient material train: cornell's material_light_from_scratch
     at full width through the entry point, warm-started from phase 24's
     checkpoint (3 warmup + N timed steps), then material_light_finetune
     warm-started from it (3 warmup + 3 timed steps, shadow rays), each at
     the largest of batch 8192, 4096, ... that fits (each cut printed with
     the memory at the failing request): step time, rays/s, peak memory,
     shadow rays and kernel launches per step, the checkpoint, a resuming
     run, one 48^2 test view; then one step with every scatter held against
     its plain version, and the kernel timed against index_add_ on the
     stage's largest leveled call.
 27. trainer SLF reference: phase 21's method on the surface-light-field
     material stage of configs/synthetic_spheres.gin
     (material_surface_light_field_light with resampling and the SLF
     variate bound): the SLF memory queried along the secondary rays, the
     variate's cache estimate on its own secondary rays, the distillation
     loss; every loss term (material_surface_light_field among them) and
     every gradient leaf, the limit bracketed by a CPU noise floor (the ray
     origins +-1 ulp) and two faults planted in the leveled kernel; 4
     leveled launches per step (the cache's primary samples, the variate's
     cache queries, material smoothness's "geometry" pass, the light
     sampler's grid), each held against its plain version;
 28. trainer SLF train: material_surface_light_field_light_resample as
     train_one_stage.py builds it (sample factor 8: 64 memory queries and
     128 cache queries per surface point) on the full-width
     configs/ngp_yobo.gin through train_with_trainer, in-process,
     warm-started from phase 20's checkpoint, at the largest of batch 1024,
     512, 256 that fits (each cut printed with the memory at the failing
     request): 3 warmup + N timed steps, every loss term finite and
     present, no kernel launch, peak memory, the checkpoint, a resuming run
     that takes no step, one 48^2 test view; then one step of the
     cache-side surface_light_field_light stage at batch 8192 (no memory,
     its distillation loss 0), timed, with its peak memory.
 29. trainer InvProp reference: phase 23's method, at its widths with 96
     bins, on the cache stages of the other InvProp scenes without their
     data: statue_fwp (the vignette map, 1 channel, the 83-tap Gaussian
     temporal filter, shadow rays, the learnable light the cache reads from
     its material model's shader; no calibration checkpoint), kettle_fwp
     (the transient ambient term) and cornell_steady_state (the iToF data
     loss): every loss term and every gradient leaf of one step, GPU
     against CPU, each limit bracketed by its CPU noise floor and two faults
     planted in the leveled kernel; 1 leveled launch per step, held against
     its plain version; then statue's temporal filter alone on [4096, 1933,
     1], GPU against CPU, and its forward and backward timed;
 30. trainer InvProp train: statue_fwp's cache stage at full width (1933
     bins, 1 channel, the 83-tap filter, shadow rays) through the entry
     point at the largest of batch 8192, 4096, 2048 that fits (3 warmup + N
     timed steps), then its material_light_from_scratch warm-started from
     it at the largest of 4096, 2048, 1024 (3 warmup + 3 timed), then the
     cache stages of kettle_fwp and cornell_steady_state at 8192 or 4096 (3
     warmup + N timed); each a cut printed with the memory at the failing
     request, ms per step, rays/s, peak memory, leveled launches per step,
     the filter's conv1d time per step (forward and backward, CUDA events),
     the checkpoint, a resuming run, one test view; then one step with
     every leveled call held against its plain version.
 31. trainer baseline reference: phase 23's method on the cache stages of
     InvProp's baseline scenes at its widths (64 bins): cornell_fwp (the
     passive transient shader: no light, no transient of its own) and
     cornell_tnerf (no indirect light: a zero transient the render
     shifts); and at ngp_yobo.gin's narrow widths (batch 64, 16 samples
     per level, 16-wide MLPs and SLF, 4096-row grids) on nero_ngp_yobo_bell
     (the SLF's distance head over the shader's bottleneck, 8 points per
     query, the reflectance grid) and open_ngp_yobo_egg (the origins'
     encoding, the SLF's own grid as its bottleneck; the far plane at 4):
     every loss term and every gradient leaf of one step, GPU against CPU,
     each limit bracketed by its CPU noise floor and two faults planted in
     the leveled kernel; 1, 1, 1 and 2 leveled launches per step, each held
     against its plain version;
 32. trainer baseline train: the cache stages of cornell_fwp and
     cornell_tnerf (700 bins) and of open_ngp_yobo_egg (the 2^19-row
     reflectance grid at 8 points per sample, the SLF's own grid) at full
     width through the entry point, each at the largest of batch 8192,
     4096, 2048 that fits, as phase 30 (the launches asserted: 1 leveled
     per step on cornell's, on open's 1 planes for the reflectance grid
     and 1 leveled for the own grid from 4096 on); then open's two SLF
     table-gradient calls of its checked step timed against index_add_.
 33. disk reference: the port's PNG reader on PNGs of every colour type at
     8 and 16 bits written by the script (the five scanline filters in turn,
     no PIL) and its EXR reader on a FLOAT EXR, equal to what was written
     as PIL reads it; then small scenes in the layouts of the blender
     (hotdog), ORB (orb_ngp_yobo_teapot: EXR images, mask PNGs) and NeRO
     glossy-synthetic (nero_ngp_yobo_bell: pickled cameras, RGBA and 16-bit
     depth PNGs) loaders, rendered on the card from the procedural spheres:
     the first three batches the card gets equal the CPU loader's, and one
     cache step of each at NGP_NARROW's widths, GPU against CPU, as phase
     31 (0, 2 and 1 leveled launches; the hotdog's step launches none, so
     no fault is planted there);
 34. disk train: the three scenes at their captures' sizes, their view
     counts cut (hotdog 20 train views of 800^2 RGBA, the teapot 14 train
     views of 2048^2 EXR read at factor 4, the bell 14 views of 800^2 with
     depth PNGs),
     through the entry point as train_one_stage.py builds its command: the
     README's two hotdog stages (cache at 8192, then
     material_light_from_scratch_resample at sample factor 8 and batch 1024,
     warm-started from it) and the teapot's and the bell's cache stages at
     the largest of 8192, 4096, 2048 that fits; each with its loading's
     wall seconds, decode seconds per image and host GiB, ms per step,
     rays/s, peak GiB, the launches (asserted: none on the hotdog, on the
     teapot 1 leveled + 1 planes, on the bell 1 planes per step at 8192),
     one held-out view's PSNR (hotdog's test views written at 200^2), and
     a step with every scatter call held against its plain version; then
     train_one_stage --vis_only on the hotdog's material checkpoint over
     its first test view: results.txt, the saved render, no launch.
 35. transient disk reference: small scenes in the layouts of cornell's
     (transient_simulation: the simulation's transforms JSONs, [H, W, bins,
     3] frames) and statue_fwp's (fwp_transient_captured: per-frame
     intrinsics, [H, W, bins] frames, a pulse .npy) captures, with the
     pre-shuffled sample streams train_efficient/{x,y,samples,
     file_indices}.h5, rendered on the card from the procedural spheres'
     direct transients and written by the port's HDF5 writer (4 train
     views' stream of 2048 rays, 2 test frames of 32^2 read at 8^2, the
     reference widths' bins from bin 4): every file read back by the port's
     reader equal to what was written; the card's first three batches and an
     eval view equal to the CPU loader's bit for bit; one cache step at
     reference widths GPU against CPU as phase 29 (1 leveled launch each);
 36. transient disk train: cornell's layout at full width (a stream of
     131,072 rays x 700 bins x 3 from 256^2 views, one 256^2 test frame, the
     config's size bound to 256) and statue_fwp's
     (65,536 rays x 3000 bins read from bin 1067, a Gaussian pulse of 85
     bins, no calibration checkpoint), through the entry point: cornell's
     cache stage at 8192, its material_light_from_scratch at 4096
     warm-started from it, statue's cache stage at 4096 (each cut printed
     if it runs out of memory); the write and load seconds, ms per step,
     rays/s, peak GiB, leveled launches per step (1, 6, 1), next_train's
     host ms, an eval view's seconds, a step with every leveled call held
     against its plain version; then train_one_stage --vis_only on
     cornell's cache checkpoint over its first view (256^2 x 700 bins):
     results.txt, and the transient saved as h5 read back by the port's
     reader equal to what was saved.
 37. real disk reference: the script's baseline JPEG writer (4:2:0, the
     Annex K tables at a quality, restart markers, a scan per component)
     against the port's decoder: the C entropy decoder's coefficient
     blocks equal the writer's quantised coefficients, the pixels within
     JPEG_FLOAT_TOL of the writer's float reconstruction; then small scenes
     in the layouts of the open_illum (open_ngp_yobo_egg: OpenIllumination's
     JPEG views, mask PNGs), neilf (neilf_ngp_yobo_castel: sfm_scene.json)
     and glossy_real (glossy_ngp_yobo: cache.pkl, a PLY point cloud)
     loaders, rendered on the card from the procedural spheres and written
     with that writer: the first three batches the card gets equal the CPU
     loader's, and one cache step of each at NGP_NARROW's widths, GPU
     against CPU, as phase 33 (2 leveled launches each);
 38. real disk train: the three layouts at cut sizes (open_egg 12 train
     and 4 test views of 2048 x 1536 read at factor 2, its test split at
     factor 8; neilf_castel 24 views of 1536 x 1024 at factor 4;
     glossy_bear 24 views of 1024 x 768), through the entry point as
     train_one_stage.py builds its command: open_egg's cache stage at the
     largest of 8192, 4096, 2048 that fits, then the README's second stage
     (material_light_from_scratch_resample at sample factor 8) warm-started
     from it at the largest of 1024, 512, 256, then 3 timed steps of the
     neilf and glossy cache stages; each with the writing's seconds, the
     loading's wall seconds, JPEG decode and resize seconds per call and
     host GiB, ms per step, rays/s, peak GiB, the launches (asserted: 1
     leveled + 1 planes per cache step at 8192, the material stage's six
     SLF table gradients), one held-out view's PSNR, and a step with every
     scatter call held against its plain version.
 39. eval extras: hotdog's 800^2 test view in the blender layout, read by
     the port's loader, against the spheres rendered 3% larger: the metric
     harness on the card (psnr, ssim, lpips, lpips_calibrated, avg_err)
     with LPIPS against the CPU's on the same pair, the ms of one 800^2
     LPIPS pair and its peak memory, E-LPIPS at dropout_keep=1.0 against
     the CPU's; the secondary-ray probe (Trainer.render_secondary_rays) of
     hotdog's material stage at reference widths, GPU against CPU, with its
     1-ulp noise floor and two encoder faults; a Config.profile_dir trace
     of open_ngp_yobo_egg's cache stage at full width through the entry
     point (5 steps, held to hold CUDA kernels, the table-gradient kernels'
     launches and the steps' labels); the environment and quadrature
     samplers over an EXR env map on the card against the CPU.
 40. data parallel: two gloo ranks (parallel/mesh.spawn) share the card,
     each with its half of the flagship cache step's 8192 rays and of the
     material step's 1536, against one process on the global batch: the
     losses and every all-reduced gradient leaf in relative L2, the limit
     bracketed by the one-process noise floor (origins +1 ulp, on the
     card) and a planted fault (rank 1 keeping its own gradient); the
     parameters bitwise equal across ranks; each rank's scatters of one
     step held against their plain versions on its own route (the
     material step's secondary samples take the leveled kernel on a rank:
     1 and 3 leveled launches per step, no planes); 2 warmup + 3 timed
     steps: step ms, rays/s, the all-reduce's ms (CUDA events) and bytes,
     peak GiB per rank, beside the one process's; then torchrun
     --standalone --nproc_per_node 1 on train_with_trainer (a one-rank NCCL
     world) for 4 steps of the full-width ngp_yobo.gin cache stage with its
     checkpoint.
 41. colmap reference: a capture in mip-NeRF 360's layout written by the
     script (write_colmap_scene: sparse/0/cameras.bin with one OPENCV
     camera, k1 -0.03, k2 0.01, p1 1e-4, p2 -1e-4; sparse/0/images.bin;
     9 JPEG views of 128 x 96 in images_4/, rendered on the card through
     the distorted cameras the llff loader hands the model, the port's
     Newton undistortion included): the poses read back by the port's
     COLMAP reader; the llff loader's arrays equal on the CPU and serving
     the card, the card's first three batches equal to the CPU loader's;
     the train step's cast on the card (the Newton solve in float32)
     against the loader's host cast within COLMAP_CAST_TOL; one cache step
     of configs/ngp_yobo.gin at NGP_NARROW's widths with the rays cast in
     the step, GPU against CPU (every loss term and every gradient leaf,
     the limit bracketed by the CPU noise floor with the cameras +-1 ulp
     and two faults planted in the card's encoder forward; no scatter
     launch);
 42. colmap train: the same layout at garden's factor-4 size (16 views of
     1297 x 840, llffhold 8 holding out 2; sparse/0 at 5188 x 3360),
     through the train_with_trainer entry point with Config.data_dir on
     the scene and Config.factor = 4: configs/ngp_yobo.gin's cache stage
     at batch 8192, its rays cast on the host, then with
     Config.cast_rays_in_train_step = True (the Newton solve on the card in
     every step), 3 timed steps each: the writing's seconds, the loading's
     wall seconds and JPEG decodes, next_train host ms, step ms, rays/s,
     peak GiB, no kernel launch, one held-out view (the second run's, cast
     from Pixels on the host; the first run evaluates none); then the flagship cache
     model (flagship.py, batch 8192) on the scene's batches cast in the
     step: 3 steps with every leveled call held against its plain version,
     5 timed, then 5 on batches cast on the host, 1 leveled launch per step
    (launches_by_path colmap_*).
 43. multi illum: a small open_egg object (phase 37's size) with
     illuminations 011 and 009 rendered on the card under the point light
     turned about +z by 120 and 240 degrees and the three illuminations'
     Radiance env maps (32 x 64, written by the script): the loader under
     Config.multi_illumination serving the card equal to the CPU's
     (arrays, env-map tables, the first three batches, light indices 0-2),
     one cache_multi_illum step at NGP_NARROW's widths with the
     illumination embeddings of the four shaders on and
     Config.multiple_illumination_outputs = False, GPU against CPU as phase
     37 (2 leveled launches, each held against its plain version), and the
     configs' own multiple_illumination_outputs = True through the entry
     point raising the reference gap's error before its first step; then
     phase 38's open_egg object with the two other illuminations written
     beside it, through the entry point as train_one_stage.py builds its
     command: cache_multi_illum at the largest of 8192, 4096, 2048 that
     fits, then material_light_from_scratch_resample_multi_illum
     warm-started from it at the largest of 1024, 512, 256, as phase 38
     (the launches asserted: 1 leveled + 1 planes per cache step at 8192,
     six leveled per material step; the material stage's light_sampling
     NaN in every step, as JAX computes it; launches_by_path multi_illum_*).
 44. options and the mesh shortcut: the card against the CPU on the patch
     batch stream (4 x 4 patches at batch 8192, host-cast and Pixels), the
     three sphere shadings under their multi-illumination, the panorama
     cast in the step against the host's cast, ops/mesh.py's intersect on a
     20,480-face icosphere at 8192 rays (and its time), one narrow
     synthetic_spheres.gin cache step on patch batches with the patch loss
     and one narrow flagship cache step under the mesh shortcut (each with
     its noise floor, two planted leveled faults and its leveled call held
     against the plain version); then synthetic_spheres.gin's cache stage
     through the entry point at batch 8192 with physical_glossy, its
     multi-illumination, Config.patch_size = 4 and the patch loss (1 leveled
     launch per step, a checked step), the full-width flagship cache step
     with the icosphere handed to the model (its step ms and intersect's
     ms, a checked step), and ORB's loader with Config.vis_render_path on a
     small ORB scene, two of its 120 path frames rendered through
     orb_ngp_yobo_teapot.gin's cache model (launches_by_path options_*).
 45. sampling options: narrow steps GPU vs CPU (noise floor with the origins
     +-1 ulp, two planted faults) of the flagship cache under option set A
     (julier control points with a Cholesky root and a scale-aware grid
     query, the covariance options, the feature filter with its far field
     on primary rays, density noise, corrected and offset normals,
     glorot_uniform kernels, the near anneal, the normal / far-field /
     uniform radii, the sample network, the "piecewise" ray warp, a random
     background with the colour network, Config.volume_variate; 1 planes
     call), of the flagship material model under set B (the secondary
     rays' field-of-view and backwards filters, their uniform radius with
     normalize_uniform_weights, the backfacing near filter,
     Config.volume_variate_secondary), of the transient material model
     under Config.volume_variate_material (which raises on the steady
     model, as in JAX), and of the cache with a triplane and a TensoRF
     appearance grid (no kernel launched); then the flagship grid's
     backward on the 1,835,008 julier points of 8192 x 32 samples, the
     concat reduction on the leveled kernel and the mean on the planes
     kernel, each against its plain backward and timed against index_add_
     and its bound; then the full-width set-A cache step at 8192 (1 planes
     launch per step) and set-B material step at 1536, a checked step and
     3 warmup + --trainer-steps timed each (launches_by_path sampling_*).
 46. material options: the visible-normal GGX sampler, the Gaussian pyramid,
     the mip-NeRF 360 proposal loss and the per-point and global BRDF
     corrections, the card against the CPU at full-width shapes; narrow
     steps GPU vs CPU (noise floor, two planted faults) of the flagship
     material model under option set C (the anisotropic BRDF correction,
     reparam_roughness, emission with a window and variate weights, MIS off
     under a stratified generator, stopgrad_light=False,
     resample_cache=False, the emission, maximum_radiance and extra_ray
     losses: 4 leveled + 2 planes calls) and set C' (residual albedo with
     its loss, one diffuse lobe, a constant material, material_correlation
     by its weights), of the flagship cache under set D (rawnerf under the
     combined and norm scalings, the non-spline interlevel loss, the
     eikonal loss on every level, normalize_weight, debug_mode; no kernel)
     and with two micro-steps of gradient accumulation on two batches,
     each clipped (2 leveled calls; the update's mean gradient also held
     against the two batches' steps alone, averaged, on the card), and of
     the transient cache under a two-scale Gaussian pyramid; the
     steady shader without indirect lobes raising as JAX fails; then the
     full-width set-C material step at 1536, the set-D cache step with
     accumulation at 8192 (2 micro-steps per update) and the pyramid's
     transient cache step at 2048 x 700 bins, a checked step and 3 warmup +
     --trainer-steps timed each (launches_by_path material_options_*).
 47. slice: the SLF's remaining options, the environment map, the cache
     model's own resampling: narrow Trainer steps GPU vs CPU (noise floor,
     two planted faults) of nero_ngp_yobo_bell under SLF option set E (the
     points' integrated encoding, the sphere point, sorted distances with
     the point nudge, the roughness-scaled reflectance query and its
     density head; 1 planes call, the planes threshold lowered) and set E'
     (voxel-plane placement, the far-field point; 1 leveled), and of
     open_ngp_yobo_egg's cache (2 leveled) and SLF material stage (8
     leveled) with the environment map on the cache, its shader and the
     material shader, and of ngp_yobo.gin's cache with the steady shader's
     active path and its shadow rays (no kernel); then bell's cache stage
     under set E, egg's with the map and ngp_yobo's with the active shader
     at the largest of 8192, 4096, 2048, egg's SLF material stage
     with the map at 1024 warm-started from it (the entry point, 2 warmup +
     2 timed steps, launches per step asserted against a checked step's),
     and the flagship cache under resample_argmax at 8192 (launches_by_path
     slice_*).
Every evaluation through the trainer (phases 20-38, 42-44) scores LPIPS on
the card beside PSNR and SSIM, and phase 34's hotdog material stage
renders the secondary-ray probe (256 x 512) at its evaluation.
Then the kernels JSON line, the eval JSON line, the transient material JSON
line, the trainer JSON line, the nvidia-smi line, and the result line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import traceback


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def _patched(module, **attrs):
    """Set attributes of `module` for the length of a block: the planted
    faults, the checking wrappers and the reference layout threshold."""
    saved = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def _cuda_ms(fn, repeats=11, warmup=2):
    """Median of per-call device times (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _abs_sum_bound(idx, w, ct, num_rows, corners, plain=None, **kw):
    """Per-entry sum of |w * ct| over the updates it receives."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    plain = plain or scatter_cuda.scatter_add_weighted_leveled_plain
    features = ct.shape[-1] if idx.dim() == 2 else ct.shape[1]
    return plain(idx, w.abs(), ct.abs(), num_rows=num_rows, features=features, corners=corners,
                 **kw)


# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM
# bytes/s and float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def _bound(nbytes, flops):
    """(bound_ms, bound_by): the least time for `nbytes` of device memory
    traffic (each input read once, each output written once) and `flops`
    float32 operations, and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _index_add_call(idx, rows, num_rows):
    """One PyTorch call of a row scatter's sum, for `library_ms`: index_add_
    of the update rows [L, N, F] (for a weighted scatter, the products
    w * ct formed beforehand) into a fresh flat [L * num_rows, F] table."""
    import torch

    levels, features = idx.shape[0], rows.shape[-1]
    offsets = torch.arange(levels, device=idx.device, dtype=torch.int64)[:, None] * num_rows
    flat_idx = (idx.reshape(levels, -1).to(torch.int64) + offsets).reshape(-1)
    flat_rows = rows.reshape(-1, features).contiguous()
    return lambda: torch.zeros(levels * num_rows, features, device=rows.device).index_add_(
        0, flat_idx, flat_rows)


def _update_rows(kind, w, ct, corners):
    """The products w * ct of a weighted scatter's updates, in the order of
    its idx: leveled [L, P*U, F] from ct [L, P, F], planes [L, U, P, F] from
    ct [L, F, P]."""
    if kind == "planes":
        return w[..., None] * ct.transpose(1, 2)[:, None]
    return w[..., None] * ct.repeat_interleave(corners, dim=1)


def _alternating_ms(fns, rounds=2):
    """Per-call device time of each of `fns` (name -> function): medians of
    11 calls by CUDA events (_cuda_ms), taken in turns, the functions in
    order and then in reverse; each is the median of its `rounds` turns."""
    names, times = list(fns), {k: [] for k in fns}
    for r in range(rounds):
        for k in names if r % 2 == 0 else names[::-1]:
            times[k].append(_cuda_ms(fns[k]))
    return {k: statistics.median(v) for k, v in times.items()}


def _kernel_vs_library(kind, idx, w, ct, kw):
    """On one update set: the `kind` kernel and one index_add_ of its update
    rows, timed in turns (_alternating_ms: "kernel", "library")."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    kernel = getattr(scatter_cuda, f"scatter_add_weighted_{kind}")
    fns = {"kernel": lambda: kernel(idx, w, ct, **kw),
           "library": _index_add_call(idx, _update_rows(kind, w, ct, kw["corners"]),
                                      kw["num_rows"])}
    return _alternating_ms(fns)


def _host_ms(torch, fn, repeats=11):
    """Median host time of one call of `fn`, which returns without
    synchronising: what the call costs the host (its Python, allocations and
    launches), the floor of its time on an idle card."""
    times = []
    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times[1:]) * 1e3


def _per_level_ms(kind, idx, w, ct, kw):
    """[{"kernel": ms, "library": ms}] of each level's slice alone."""
    return [_kernel_vs_library(kind, idx[lv:lv + 1], w[lv:lv + 1], ct[lv:lv + 1], kw)
            for lv in range(idx.shape[0])]


def _levels_text(per_level, sizes):
    return ", ".join(f"{s if isinstance(s, str) else f'{s}^3'} {t['kernel']:.4f}/"
                     f"{t['library']:.4f}" for s, t in zip(sizes, per_level))


# Float32 sums of the same terms in another order (atomics vs index_add_)
# differ by at most (n - 1) * eps * sum|terms|; rounding errors grow like
# sqrt(n) in practice. 2e-5 * sum|terms| (~170 eps) covers a 16^3-level cell
# receiving up to ~3e4 updates.
SUM_ORDER_TOL = 2e-5


def phase_kernel(torch, device, seed):
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    levels, points, corners, features, num_rows = 6, 262144, 4, 4, 524288
    gen = torch.Generator(device=device).manual_seed(seed)
    # Real encoder taps of uniform points: the 16^3 dense level funnels
    # ~1M updates into 4,096 rows, as on the main path.
    x = torch.rand((points, 3), generator=gen, device=device)
    rows, weights = hashgrid._tap_rows_and_weights(
        x, None, (16, 32, 64, 128, 256, 512), num_rows, 3, "simplex")
    idx = rows.permute(1, 0, 2).reshape(levels, -1).contiguous()
    w = weights.permute(1, 0, 2).reshape(levels, -1).contiguous()
    ct = torch.randn((levels, points, features), generator=gen, device=device)
    kw = dict(num_rows=num_rows, features=features, corners=corners)

    def check(idx, w, ct):
        got = scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **kw)
        want = scatter_cuda.scatter_add_weighted_leveled_plain(idx, w, ct, **kw)
        bound = _abs_sum_bound(idx, w, ct, num_rows, corners)
        torch.cuda.synchronize()
        err = (got - want).abs()
        max_rel = float((err / want.abs().clamp(min=1e-30))[want.abs() > 1e-3].max())
        return float(err.max()), max_rel, bool((err <= SUM_ORDER_TOL * bound + 1e-30).all())

    max_abs, max_rel, ok = check(idx, w, ct)
    hot = int(torch.bincount(idx[0].long(), minlength=4096).max())
    del rows, weights
    ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **kw))
    plain_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled_plain(idx, w, ct, **kw))
    library_ms = _cuda_ms(_index_add_call(idx, _update_rows("leveled", w, ct, corners), num_rows))
    n = levels * points * corners
    bound_ms, bound_by = _bound(4 * (2 * n + levels * points * features
                                     + levels * num_rows * features), 2 * n * features)

    # The same shape on camera-ray samples (8192 rays x 32 sorted samples,
    # as the rows phase draws them): neighbouring points share cells, as on
    # the path.
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    x = _primary_sample_points(torch, device, gen, 8192, 32).reshape(-1, 3)
    rows, weights = hashgrid._tap_rows_and_weights(x, None, MATERIAL_LEVELS, num_rows, 3,
                                                   "simplex")
    r_idx = rows.permute(1, 0, 2).reshape(levels, -1).contiguous()
    r_w = weights.permute(1, 0, 2).reshape(levels, -1).contiguous()
    r_ct = torch.randn((levels, points, features), generator=gen, device=device)
    del x, rows, weights
    ray_abs, _, ray_ok = check(r_idx, r_w, r_ct)
    ray = _kernel_vs_library("leveled", r_idx, r_w, r_ct, kw)
    ray_plain_ms = _cuda_ms(
        lambda: scatter_cuda.scatter_add_weighted_leveled_plain(r_idx, r_w, r_ct, **kw))
    print(f"kernel: scatter_add_weighted_leveled L={levels} P={points} U={corners} F={features} "
          f"rows={num_rows} (16^3 level: max {hot} updates on one row) "
          f"max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"tol=|err|<={SUM_ORDER_TOL}*sum|w*ct| {'ok' if ok else 'FAIL'} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(index_add_ of w*ct rows)="
          f"{library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) (median of 11, CUDA events); "
          f"on camera-ray samples (8192 rays x 32): max_abs_err={ray_abs:.3e} same tol "
          f"{'ok' if ray_ok else 'FAIL'} kernel_ms={ray['kernel']:.4f} "
          f"library_ms={ray['library']:.4f} (medians of 11 in 2 alternating turns) "
          f"plain_ms={ray_plain_ms:.4f}", flush=True)
    if not (ok and ray_ok):
        raise AssertionError("kernel disagrees with its plain version")
    return dict(max_abs_err=max(max_abs, ray_abs), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                camera_ray_ms=ray["kernel"], camera_ray_library_ms=ray["library"],
                camera_ray_plain_ms=ray_plain_ms)


def phase_encoder(torch, device, seed):
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.models import grids
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    params = flagship.flagship_cache_params()["sampler_params"]["grid_params_per_level"][2]
    grid = grids.HashEncoding(**params).to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.rand((8192, 32, 1, 3), generator=gen, device=device)
    ct = torch.randn((8192, 32, 6 * 4), generator=gen, device=device)
    sizes = tuple(int(s) for s in grid.grid_sizes[:6])
    statics = dict(grid_sizes=sizes, table_size=grid.hash_map_size,
                   dense_offsets=grid.dense_offsets, interpolation="simplex")

    def grads(scatter_fn):
        grid.zero_grad(set_to_none=True)
        f = hashgrid.multires_grid_encode(
            x, grid.hash_levels[:3], grid.dense_levels, scatter_fn=scatter_fn, **statics)
        f.backward(ct)
        return grid.hash_levels.grad.clone(), grid.dense_levels.grad.clone()

    before = scatter_cuda.launches["leveled"]
    h_k, d_k = grads(None)
    launched = scatter_cuda.launches["leveled"] - before
    h_p, d_p = grads(scatter_cuda.scatter_add_weighted_leveled_plain)
    torch.cuda.synchronize()
    errs = []
    for a, b in ((h_k, h_p), (d_k, d_p)):
        scale = float(b.abs().max())
        errs.append(float((a - b).abs().max()) / scale)
    ok = launched == 1 and max(errs) <= 1e-5 and float(h_k[3:].abs().max()) == 0.0
    print(f"encoder: flagship grid backward (8192x32 points, 6 of 8 levels) kernel vs plain "
          f"rel_err hash={errs[0]:.3e} dense={errs[1]:.3e} (tol 1e-5 of max |grad|), "
          f"clamped levels zero, launches={launched} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("encoder gradients disagree")


def _narrow(params):
    p = copy.deepcopy(params)
    sp = p["sampler_params"]
    mlps = [dict(m) for m in sp["mlp_params_per_level"]]
    for m in mlps[:2]:
        m.update(net_width=32, net_depth=2, use_bf16_compute=False)
    mlps[2].update(net_width=32)
    sp["mlp_params_per_level"] = tuple(mlps)
    sp["grid_params_per_level"] = (None, None, dict(sp["grid_params_per_level"][2],
                                                    hash_map_size=2**14, max_grid_size=512))
    p["shader_params"].update(net_width=32, bottleneck_width=32, use_bf16_compute=False)
    return p


# Model-level gradients are held per leaf in relative L2 norm, not entry by
# entry: a sample that moves by a rounding error can cross a grid cell and
# move its table update to a neighbouring row. The limit sits between two
# readings the reference phase takes in every run: the noise floor (the CPU
# path against itself with the ray origins moved by one float32 ulp), which
# must read below it, and planted faults in the GPU scatter, which must read
# above it.
GRAD_REL_L2_TOL = 5e-2


def _planted_fault(fault, kind="leveled"):
    """A scatter with a deliberate fault, for the reference phases' check
    that their gradient limit would catch one. On the dedup'd stream (one
    update per row, corners 1), "taps rotated" moves each update's weight to
    the next update."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    real = getattr(scatter_cuda, f"scatter_add_weighted_{kind}")

    def scatter(idx, w, ct, **kw):
        if fault == "taps rotated" and kind == "planes":  # [L, U, P]: roll the taps
            w = w.roll(1, dims=1).contiguous()
        elif fault == "taps rotated" and kw["corners"] == 1:
            w = w.roll(1, dims=-1).contiguous()
        elif fault == "taps rotated":  # each tap's weight goes to the next corner
            w = w.reshape(w.shape[0], -1, kw["corners"]).roll(1, dims=-1).reshape(w.shape)
            w = w.contiguous()
        out = real(idx, w, ct, **kw)
        if fault == "finest level dropped":
            out[-1] = 0
        return out

    return scatter


def phase_reference(torch, device, seed):
    """Same narrow model and batch on the GPU (kernel) and the CPU (plain)."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    cfg = flagship.cache_config(batch_size=512, lr_delay_steps=0)
    params = _narrow(flagship.flagship_cache_params())
    batch = datasets.SyntheticSpheres("train", None, cfg, num_images=4, resolution=32,
                                      device="cpu").next_train()
    origins = batch.rays.origins
    nudged = batch.replace(rays=batch.rays.replace(
        origins=torch.nextafter(origins, torch.full_like(origins, float("inf")))))

    def step(dev, b, fault=None):
        torch.manual_seed(seed)
        model = flagship.build_flagship_cache_model(cfg, params, device=dev)
        state, _ = train.create_optimizer(cfg, model)
        before = scatter_cuda.launches["leveled"]
        patch = dict(scatter_add_weighted_leveled=_planted_fault(fault)) if fault else {}
        with _patched(scatter_cuda, **patch):
            _, stats = train.create_train_step(model, cfg)(None, state, b.to(dev), 0.5)
        losses = {k: float(torch.as_tensor(v).detach()) for k, v in stats["losses"].items()}
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        return losses, grads, scatter_cuda.launches["leveled"] - before

    def worst_grad_err(g, ref):
        errs = {k: float((g[k] - ref[k]).norm()) / max(float(ref[k].norm()), 1e-30) for k in ref}
        worst = max(errs, key=errs.get)
        return errs[worst], worst

    l_cpu, g_cpu, n_cpu = step("cpu", batch)
    floor, floor_at = worst_grad_err(step("cpu", nudged)[1], g_cpu)
    l_gpu, g_gpu, n_gpu = step(device, batch)
    loss_err = max(abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu)
    err, err_at = worst_grad_err(g_gpu, g_cpu)
    faults = {f: worst_grad_err(step(device, batch, f)[1], g_cpu)
              for f in ("taps rotated", "finest level dropped")}
    finite = all(torch.isfinite(g).all() for g in g_gpu.values())
    # Same float32 math on two devices, summed in other orders: losses agree
    # to 1e-4.
    ok = (finite and loss_err <= 1e-4 and n_cpu == 0 and n_gpu == 1
          and floor <= GRAD_REL_L2_TOL and err <= GRAD_REL_L2_TOL
          and all(v > GRAD_REL_L2_TOL for v, _ in faults.values()))
    print(f"reference: narrow cache model, batch 512, gpu vs cpu: loss rel_err={loss_err:.3e} "
          f"(tol 1e-4) grad rel_l2_err max={err:.3e} at {err_at} (tol {GRAD_REL_L2_TOL}; "
          f"noise floor, cpu vs cpu with origins +1 ulp: {floor:.3e} at {floor_at}; planted "
          + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
          + f", each must exceed the tol) kernel launches gpu={n_gpu} cpu={n_cpu} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("GPU path disagrees with the CPU reference path")


# The flagship material shape: 1536 rays x 32 secondary rays x 32 final
# samples, the secondary-ray level clamp of 6 (16^3, 32^3, 64^3 dense; 128,
# 256, 512 hashed), simplex taps, F = 4, T = 2^19 rows.
MATERIAL_POINTS = 1536 * 32 * 32
MATERIAL_LEVELS = (16, 32, 64, 128, 256, 512)


def _secondary_sample_points(torch, device, gen, num_rays, samples_per_ray):
    """Grid coordinates of samples spread as secondary samples are: rays from
    points on the central sphere in random directions, sampled from 0.1 to
    the secondary far plane 4, warped by the flagship's contraction."""
    from neural_radiance_caching_tpu_torch.ops import coord

    n = torch.randn((num_rays, 3), generator=gen, device=device)
    origins = 0.55 * n / n.norm(dim=-1, keepdim=True)
    d = torch.randn((num_rays, 3), generator=gen, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    t = 0.1 + 3.9 * torch.rand((num_rays, samples_per_ray), generator=gen, device=device)
    points = origins[:, None] + t[..., None] * d[:, None]
    return (coord.contract_radius_2(points) + 2.0) / 4.0  # bbox [-2, 2]^3 -> [0, 1]^3


def phase_kernel_planes(torch, device, seed):
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    levels, corners, features, num_rows = len(MATERIAL_LEVELS), 4, 4, 524288
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    x = _secondary_sample_points(torch, device, gen, 1536 * 32, 32).reshape(-1, 3)
    rows, weights = hashgrid._tap_rows_and_weights(
        x, None, MATERIAL_LEVELS, num_rows, 3, "simplex")
    del x
    idx = rows.permute(1, 2, 0).contiguous()  # [L, U, P]
    w = weights.permute(1, 2, 0).contiguous()
    del rows, weights
    ct = torch.randn((levels, features, MATERIAL_POINTS), generator=gen, device=device)
    kw = dict(num_rows=num_rows, features=features, corners=corners)

    # The leveled kernel on the same updates, in its own layout, is held to
    # the same plain sum.
    l_idx = idx.permute(0, 2, 1).reshape(levels, -1).contiguous()
    l_w = w.permute(0, 2, 1).reshape(levels, -1).contiguous()
    l_ct = ct.permute(0, 2, 1).contiguous()
    got = scatter_cuda.scatter_add_weighted_planes(idx, w, ct, **kw)
    lev = scatter_cuda.scatter_add_weighted_leveled(l_idx, l_w, l_ct, **kw)
    want = scatter_cuda.scatter_add_weighted_planes_plain(idx, w, ct, **kw)
    limit = SUM_ORDER_TOL * _abs_sum_bound(
        idx, w, ct, num_rows, corners, plain=scatter_cuda.scatter_add_weighted_planes_plain) + 1e-30
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    lev_err = float((lev - want).abs().max())
    ok = bool(((got - want).abs() <= limit).all())
    lev_ok = bool(((lev - want).abs() <= limit).all())
    del got, lev, want, limit
    hot = int(torch.bincount(idx[0].reshape(-1).long(), minlength=4096).max())
    ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_planes(idx, w, ct, **kw))
    plain_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_planes_plain(idx, w, ct, **kw))
    leveled_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled(l_idx, l_w, l_ct, **kw))
    library_ms = _cuda_ms(_index_add_call(idx, _update_rows("planes", w, ct, corners), num_rows))
    n = levels * corners * MATERIAL_POINTS
    bound_ms, bound_by = _bound(4 * (2 * n + levels * features * MATERIAL_POINTS
                                     + levels * num_rows * features), 2 * n * features)
    per_level = _per_level_ms("planes", idx, w, ct, kw)
    print(f"kernel (planes): scatter_add_weighted_planes L={levels} U={corners} "
          f"P={MATERIAL_POINTS} F={features} rows={num_rows} (secondary-ray samples; 16^3 level: "
          f"max {hot} updates on one row) max_abs_err={max_abs:.3e} "
          f"tol=|err|<={SUM_ORDER_TOL}*sum|w*ct| {'ok' if ok else 'FAIL'}; leveled kernel on the "
          f"same updates max_abs_err={lev_err:.3e} same tol {'ok' if lev_ok else 'FAIL'}; "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} leveled_kernel_same_updates_ms="
          f"{leveled_ms:.4f} library_ms(index_add_ of w*ct rows)={library_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) (median of 11, CUDA events); each level's "
          f"slice alone, kernel/library ms: {_levels_text(per_level, MATERIAL_LEVELS)} "
          f"(medians of 11 in 2 alternating turns)", flush=True)
    if not (ok and lev_ok):
        raise AssertionError("a kernel disagrees with the plain sum at the planes shape")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, leveled_ms=leveled_ms,
                leveled_max_abs_err=lev_err, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, per_level_ms=[t["kernel"] for t in per_level],
                per_level_library_ms=[t["library"] for t in per_level])


def phase_encoder_planes(torch, device, seed):
    """Table gradients through the planes backward at the material shape."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.models import grids
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    params = flagship.flagship_cache_params()["sampler_params"]["grid_params_per_level"][2]
    grid = grids.HashEncoding(**params).to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    x = _secondary_sample_points(torch, device, gen, 1536 * 32, 32)[:, :, None]
    ct = torch.randn((1536 * 32, 32, len(MATERIAL_LEVELS) * 4), generator=gen, device=device)
    statics = dict(grid_sizes=MATERIAL_LEVELS, table_size=grid.hash_map_size,
                   dense_offsets=grid.dense_offsets, interpolation="simplex")
    assert hashgrid.use_planes_layout(x.shape[0] * x.shape[1], "mean")

    def grads(planes_fn):
        grid.zero_grad(set_to_none=True)
        f = hashgrid.multires_grid_encode(
            x, grid.hash_levels[:3], grid.dense_levels, planes_scatter_fn=planes_fn, **statics)
        f.backward(ct)
        return grid.hash_levels.grad.clone(), grid.dense_levels.grad.clone()

    before = dict(scatter_cuda.launches)
    h_k, d_k = grads(None)
    launched = {k: scatter_cuda.launches[k] - before[k] for k in before}
    h_p, d_p = grads(scatter_cuda.scatter_add_weighted_planes_plain)
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in ((h_k, h_p), (d_k, d_p))]
    ok = (launched == _launch_counts(planes=1) and max(errs) <= 1e-5
          and float(h_k[3:].abs().max()) == 0.0)
    print(f"encoder (planes): flagship grid backward at the material shape (1536x32x32 points, "
          f"6 of 8 levels) kernel vs plain rel_err hash={errs[0]:.3e} dense={errs[1]:.3e} "
          f"(tol 1e-5 of max |grad|), clamped levels zero, launches={launched} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("planes encoder gradients disagree")


# No loss reaches these parameters of the material model: the light
# sampler's outputs feed only the (unused) light importance sampler under a
# stop-gradient, the passive shaders read no light power, and the cache
# SLF's rgba head is unread. tests/test_torch_material_slice.py pins the
# same set against the JAX package's zero gradients.
_MATERIAL_UNREACHED = {
    "cache.shader.light_power", "cache.shader.surface_lf.output_rgba_layer.weight",
    "cache.shader.surface_lf.output_rgba_layer.bias", "shader.light_power",
    "light_sampler.layers.0.weight", "light_sampler.layers.0.bias",
    "light_sampler.layers.1.weight", "light_sampler.layers.1.bias",
    "light_sampler.output_layer.weight", "light_sampler.output_layer.bias",
    "light_sampler.grid.dense_levels", "light_sampler.grid.hash_levels",
}


def _launch_counts(**counts):
    """Launch counts of every kernel, zero unless given."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    return {k: counts.get(k, 0) for k in scatter_cuda.launches}


# Scatter launches per material train step: the encoder backwards a loss
# reaches, one each. Leveled: the cache's primary samples (1536 x 32 points)
# and the material grid (1536 points). Planes: the cache's secondary samples
# (1536 x 32 x 32 points). The light sampler's grid gets no gradient, and
# the gradient-debias forward runs without a graph.
_MATERIAL_LAUNCHES_PER_STEP = {"leveled": 2, "leveled_skip": 0, "planes": 1, "rows": 0}


def _narrow_material():
    """The flagship material structure at reference-phase widths. The
    secondary encoder takes the planes layout from 4,096 points on, and the
    primary-ray clamp (3) sits below the secondary one (5), so hash levels
    64^3 and 128^3... of the cache grid are reached through the planes
    kernel alone."""
    from neural_radiance_caching_tpu_torch import flagship

    strategy = ((0, 0, 16), (1, 1, 16), (2, 2, 16))
    cache = _narrow(flagship.flagship_cache_params())
    cache["sampler_params"]["sampling_strategy"] = strategy
    cache["train_sampling_strategy"] = cache["render_sampling_strategy"] = strategy
    mlps = [dict(m) for m in cache["sampler_params"]["mlp_params_per_level"]]
    mlps[2].update(primary_grid_level_clamp=3, secondary_grid_level_clamp=5)
    cache["sampler_params"]["mlp_params_per_level"] = tuple(mlps)
    return _narrow_material_shader(flagship.flagship_material_params(cache), strategy)


def _narrow_material_shader(params, strategy):
    """The light sampler and material shader of a material model's `params`
    at reference-phase widths, the shader's cache queries on `strategy`."""
    grid = dict(hash_map_size=2**14, max_grid_size=512)
    params["light_sampler_params"] = dict(
        params["light_sampler_params"], net_width=32, num_components=16,
        grid_params=dict(params["light_sampler_params"]["grid_params"], **grid))
    params["shader_params"] = dict(
        params["shader_params"], bottleneck_width=32, cache_train_sampling_strategy=strategy,
        cache_render_sampling_strategy=strategy,
        grid_params=dict(params["shader_params"]["grid_params"], **grid))
    return params


MATERIAL_REF_BATCH = 96
MATERIAL_PLANES_MIN_POINTS = 4096
# Material-model gradients are held per leaf, with each hash table split into
# its levels, in relative L2 norm. The levels only secondary rays reach sum
# few, sensitive terms: a rounding error turns a secondary ray and moves its
# samples across cells. The limit sits between the same two readings as the
# cache's: the noise floor (5.9e-2 on the CPU path, one core of the build
# sandbox) below it, the planted planes-kernel faults (1.0) above it.
MATERIAL_GRAD_REL_L2_TOL = 0.2


def _material_step(torch, device, seed, batch, fault=None):
    """One train step of the narrow material model on `device`; the random
    draws come from a CPU generator, so both devices see the same numbers."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    cfg = flagship.material_config(batch_size=MATERIAL_REF_BATCH, lr_delay_steps=0)
    torch.manual_seed(seed)
    model = flagship.build_flagship_material_model(cfg, _narrow_material(), device=device)
    state, _ = train.create_optimizer(cfg, model)
    before = dict(scatter_cuda.launches)
    patch = dict(scatter_add_weighted_planes=_planted_fault(fault, "planes")) if fault else {}
    with _patched(hashgrid, PLANES_MIN_POINTS=MATERIAL_PLANES_MIN_POINTS), \
            _patched(scatter_cuda, **patch):
        rng = torch.Generator().manual_seed(seed + 5)
        _, stats = train.create_train_step(model, cfg)(rng, state, batch.to(device), 0.5)
    losses = {k: float(torch.as_tensor(v).detach()) for k, v in stats["losses"].items()}
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return losses, grads, {k: scatter_cuda.launches[k] - before[k] for k in before}


def _per_level(grads):
    """Gradient leaves with each stacked hash table split into its levels."""
    out = {}
    for k, g in grads.items():
        if k.endswith("grid.hash_levels"):
            out.update({f"{k}[{i}]": g[i] for i in range(g.shape[0])})
        else:
            out[k] = g
    return out


def _grad_errs(g, ref):
    """The relative L2 error of each gradient leaf (each grid level its own)."""
    g, ref = _per_level(g), _per_level(ref)
    return {k: float((g[k] - ref[k]).norm()) / float(ref[k].norm()) for k in ref
            if float(ref[k].norm()) > 0}


def _worst_grad_err(g, ref, keys=None):
    errs = {k: v for k, v in _grad_errs(g, ref).items()
            if keys is None or k.split("[")[0] in keys}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def phase_material_reference(torch, device, seed):
    """Same narrow material model, batch and draws on the GPU and the CPU."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets

    cfg = flagship.material_config(batch_size=MATERIAL_REF_BATCH)
    batch = datasets.SyntheticSpheres("train", None, cfg, num_images=4, resolution=32,
                                      device="cpu").next_train()
    origins = batch.rays.origins
    nudged = batch.replace(rays=batch.rays.replace(
        origins=torch.nextafter(origins, torch.full_like(origins, float("inf")))))
    l_cpu, g_cpu, n_cpu = _material_step(torch, "cpu", seed, batch)
    reached = [k for k in g_cpu if k not in _MATERIAL_UNREACHED]
    floor, floor_at = _worst_grad_err(_material_step(torch, "cpu", seed, nudged)[1], g_cpu,
                                      reached)
    l_gpu, g_gpu, n_gpu = _material_step(torch, device, seed, batch)
    loss_err = max(abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu)
    err, err_at = _worst_grad_err(g_gpu, g_cpu, reached)
    faults = {f: _worst_grad_err(_material_step(torch, device, seed, batch, f)[1], g_cpu, reached)
              for f in ("taps rotated", "finest level dropped")}
    finite = all(torch.isfinite(g).all() for g in g_gpu.values())
    tol = MATERIAL_GRAD_REL_L2_TOL
    ok = (finite and loss_err <= 1e-3 and n_cpu == _launch_counts()
          and n_gpu == _MATERIAL_LAUNCHES_PER_STEP and floor <= tol and err <= tol
          and all(v > tol for v, _ in faults.values()))
    print(f"material reference: narrow material model, batch {MATERIAL_REF_BATCH} x 32 secondary "
          f"rays, same draws, gpu vs cpu: loss rel_err={loss_err:.3e} (tol 1e-3) grad rel_l2_err "
          f"max={err:.3e} at {err_at} (tol {tol}; noise floor, cpu vs cpu with origins +1 ulp: "
          f"{floor:.3e} at {floor_at}; planted in the planes kernel "
          + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
          + f", each must exceed the tol) kernel launches gpu={n_gpu} cpu={n_cpu} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("GPU material path disagrees with the CPU reference path")


_UNREAD_PARAMS = {"shader.light_power", "shader.surface_lf.output_rgba_layer.weight",
                  "shader.surface_lf.output_rgba_layer.bias"}


def phase_train(torch, device, seed, steps, smi, profile):
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    config = flagship.cache_config()
    t0 = time.perf_counter()
    torch.manual_seed(seed)
    model = flagship.build_flagship_cache_model(config, device=device)
    dataset = datasets.SyntheticSpheres("train", None, config, num_images=8, resolution=128,
                                        device=device)
    state, _ = train.create_optimizer(config, model)
    train_step = train.create_train_step(model, config)
    rng = torch.Generator(device=device).manual_seed(seed + 42)
    # Batches made ahead, so data loading is off the timed path.
    batches = [dataset.next_train() for _ in range(8)]
    n_params = sum(p.numel() for p in model.parameters())
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    setup_s = time.perf_counter() - t0

    warmup = 3
    losses = []
    scatter_cuda.reset_launch_count()
    for i in range(warmup):
        state, stats = train_step(rng, state, batches[i % len(batches)], 0.5)
        losses.append(stats["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        state, stats = train_step(rng, state, batches[(warmup + i) % len(batches)], 0.5)
        losses.append(stats["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launches = dict(scatter_cuda.launches)

    losses = [float(v) for v in losses]
    finite = all(map(lambda v: v == v and abs(v) != float("inf"), losses))
    unchanged = {k for k, v in model.state_dict().items() if torch.equal(v, before[k])}
    changed = len(before) - len(unchanged)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # The passive shader reads neither the light power nor the SLF's rgba
    # head: those three, and only those, keep their initial values.
    ok = (finite and unchanged == _UNREAD_PARAMS
          and launches == _launch_counts(leveled=warmup + steps))
    print(f"train: flagship cache model ({n_params} params) batch {config.batch_size} "
          f"SyntheticSpheres 8x128^2 setup {setup_s:.1f}s; {warmup} warmup + {steps} timed "
          f"steps: step_ms={dt * 1e3:.2f} rays_per_s={config.batch_size / dt:.0f} on [{smi}]; "
          f"losses finite={finite} first={losses[0]:.5f} last={losses[-1]:.5f}; "
          f"{changed}/{len(before)} param tensors changed, unchanged={sorted(unchanged)}; "
          f"scatter launches={launches} "
          f"(expected leveled {warmup + steps}, planes 0); peak {peak_gib:.2f} GiB "
          f"{'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("train phase failed")
    if profile:
        _profile(torch, train_step, state, rng, batches, profile)
    return launches["leveled"], dt


def _checking_scatter(kind, calls, capture=None, largest=False):
    """The `kind` scatter wrapper, with its plain version run on the same
    inputs after each call and held to SUM_ORDER_TOL x sum|w * ct|; each
    call is appended to `calls` (a leveled call with skip_zero_w as kind
    "leveled_skip"), with its largest |cotangent|. With `capture`, the first call's inputs are kept there
    (with `largest`, those of the call with the most updates)."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    real = getattr(scatter_cuda, f"scatter_add_weighted_{kind}")
    plain = getattr(scatter_cuda, f"scatter_add_weighted_{kind}_plain")

    def scatter(idx, w, ct, **kw):
        if capture is not None and (not capture or (
                largest and idx.numel() > capture["idx"].numel())):
            capture.clear()
            capture.update(idx=idx, w=w, ct=ct, **kw)
        out = real(idx, w, ct, **kw)
        want = plain(idx, w, ct, **kw)
        bound_kw = {k: v for k, v in kw.items() if k not in ("num_rows", "corners", "features")}
        limit = SUM_ORDER_TOL * _abs_sum_bound(idx, w, ct, kw["num_rows"], kw["corners"],
                                               plain=plain, **bound_kw) + 1e-30
        err = (out - want).abs()
        calls.append(dict(kind=kind + ("_skip" if kw.get("skip_zero_w") else ""),
                          shape=tuple(idx.shape), max_abs_err=float(err.max()),
                          ct_abs_max=float(ct.abs().max()) if ct.numel() else 0.0,
                          ok=bool((err <= limit).all())))
        return out

    return scatter


def phase_kernel_path(kind, capture, sizes, label):
    """The `kind` kernel on the updates a train step gave it (captured by
    _checking_scatter) against one index_add_ of the same update rows, in
    turns, over all levels and on each level's slice alone; the plain
    version's time, the bound, and the host time of one call of kernel and
    library."""
    import torch

    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    idx, w, ct = capture["idx"], capture["w"], capture["ct"]
    kw = {k: capture[k] for k in ("num_rows", "features", "corners")}
    times = _kernel_vs_library(kind, idx, w, ct, kw)
    per_level = _per_level_ms(kind, idx, w, ct, kw)
    kernel = getattr(scatter_cuda, f"scatter_add_weighted_{kind}")
    host = {"kernel": _host_ms(torch, lambda: kernel(idx, w, ct, **kw)),
            "library": _host_ms(torch, _index_add_call(
                idx, _update_rows(kind, w, ct, kw["corners"]), kw["num_rows"]))}
    plain = getattr(scatter_cuda, f"scatter_add_weighted_{kind}_plain")
    plain_ms = _cuda_ms(lambda: plain(idx, w, ct, **kw))
    n = idx.numel()
    bound_ms, bound_by = _bound(4 * (2 * n + ct.numel() + idx.shape[0] * kw["num_rows"]
                                     * kw["features"]), 2 * n * kw["features"])
    print(f"kernel ({kind}, path): scatter_add_weighted_{kind} on the {label}, idx"
          f"{list(idx.shape)} F={kw['features']} rows={kw['num_rows']}: kernel_ms="
          f"{times['kernel']:.4f} library_ms(index_add_ of w*ct rows)={times['library']:.4f} "
          f"ratio={times['kernel'] / times['library']:.3f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}); each level's slice alone, "
          f"kernel/library ms: {_levels_text(per_level, sizes)} (medians of 11 in 2 alternating "
          f"turns, CUDA events); host time of one call (no sync): kernel {host['kernel']:.4f} "
          f"ms, library {host['library']:.4f} ms", flush=True)
    return dict(path_ms=times["kernel"], path_library_ms=times["library"],
                path_plain_ms=plain_ms, path_bound_ms=bound_ms,
                path_host_ms=host["kernel"], path_library_host_ms=host["library"],
                path_per_level_ms=[t["kernel"] for t in per_level],
                path_per_level_library_ms=[t["library"] for t in per_level])


def phase_material_check(torch, train_step, state, rng, batch, capture=None):
    """One material train step with every scatter the path launches held
    against its plain version on the same inputs, at the path's shapes; with
    `capture`, the planes call's inputs are kept there."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    calls = []
    with _patched(scatter_cuda,
                  scatter_add_weighted_leveled=_checking_scatter("leveled", calls),
                  scatter_add_weighted_planes=_checking_scatter("planes", calls, capture)):
        state, stats = train_step(rng, state, batch, 0.5)
    torch.cuda.synchronize()
    per_kind = {k: sum(c["kind"] == k for c in calls) for k in _MATERIAL_LAUNCHES_PER_STEP}
    ok = (per_kind == _MATERIAL_LAUNCHES_PER_STEP and all(c["ok"] for c in calls)
          and bool(torch.isfinite(stats["loss"])))
    print("material train (checked step): each scatter of one step against its plain version "
          f"on the same inputs, tol=|err|<={SUM_ORDER_TOL}*sum|w*ct|: "
          + "; ".join(f"{c['kind']} idx{list(c['shape'])} max_abs_err={c['max_abs_err']:.3e} "
                      f"{'ok' if c['ok'] else 'FAIL'}" for c in calls)
          + f" (calls {per_kind}, expected {_MATERIAL_LAUNCHES_PER_STEP}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version on the material path")
    return state, {k: max(c["max_abs_err"] for c in calls if c["kind"] == k)
                   for k, n in per_kind.items() if n}


def phase_material_train(torch, device, seed, steps, smi, profile):
    """The full-width flagship material model: one checked step, whose planes
    inputs time the planes kernel, then timed steps with gradient
    checkpointing (the JAX setting), then one step without it."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    config = flagship.material_config()
    t0 = time.perf_counter()
    torch.manual_seed(seed)
    model = flagship.build_flagship_material_model(config, device=device)
    dataset = datasets.SyntheticSpheres("train", None, config, num_images=8, resolution=128,
                                        device=device)
    state, _ = train.create_optimizer(config, model)
    train_step = train.create_train_step(model, config)
    rng = torch.Generator(device=device).manual_seed(seed + 43)
    batches = [dataset.next_train() for _ in range(8)]
    n_params = sum(p.numel() for p in model.parameters())
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    setup_s = time.perf_counter() - t0
    capture = {}
    state, checked_err = phase_material_check(torch, train_step, state, rng, batches[-1], capture)
    # Timed before the train steps, and dropped, so that the peak memory
    # below is the steps' own.
    planes_path = phase_kernel_path(
        "planes", capture, MATERIAL_LEVELS,
        "material path's own updates (secondary samples of one checked step)")
    del capture

    warmup = 3
    losses = []
    torch.cuda.reset_peak_memory_stats()
    scatter_cuda.reset_launch_count()
    for i in range(warmup):
        state, stats = train_step(rng, state, batches[i % len(batches)], 0.5)
        losses.append(stats["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        state, stats = train_step(rng, state, batches[(warmup + i) % len(batches)], 0.5)
        losses.append(stats["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launches = dict(scatter_cuda.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    unchanged = {k for k, v in model.state_dict().items() if torch.equal(v, before[k])}

    # One more step without checkpointing: its peak memory.
    config.gradient_checkpointing = False
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    state, stats = train_step(rng, state, batches[0], 0.5)
    losses.append(stats["loss"])
    torch.cuda.synchronize()
    nockpt_s = time.perf_counter() - t1
    nockpt_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    config.gradient_checkpointing = True

    losses = [float(v) for v in losses]
    finite = all(map(lambda v: v == v and abs(v) != float("inf"), losses))
    per_step = {k: n * (warmup + steps) for k, n in _MATERIAL_LAUNCHES_PER_STEP.items()}
    ok = finite and unchanged == _MATERIAL_UNREACHED and launches == per_step
    print(f"material train: flagship material model ({n_params} params) batch "
          f"{config.batch_size} x 32 secondary rays x 64+64+32 samples, SyntheticSpheres 8x128^2, "
          f"setup {setup_s:.1f}s; {warmup} warmup + {steps} timed steps with gradient "
          f"checkpointing: step_ms={dt * 1e3:.2f} rays_per_s={config.batch_size / dt:.1f} "
          f"peak {peak_gib:.2f} GiB; one step without checkpointing: {nockpt_s * 1e3:.1f} ms, "
          f"peak {nockpt_peak_gib:.2f} GiB; on [{smi}]; losses finite={finite} "
          f"first={losses[0]:.5f} last={losses[-1]:.5f}; {len(before) - len(unchanged)}/"
          f"{len(before)} param tensors changed, unchanged={sorted(unchanged)} "
          f"(expected the {len(_MATERIAL_UNREACHED)} no loss reaches); scatter launches="
          f"{launches} (expected {per_step}: {_MATERIAL_LAUNCHES_PER_STEP} per step) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("material train phase failed")
    if profile:
        path = str(profile)
        stem, dot, ext = path.rpartition(".")
        _profile(torch, train_step, state, rng, batches,
                 f"{stem}.material.{ext}" if dot else path + ".material", steps=2)
    return launches, dt, checked_err, planes_path


def _primary_sample_points(torch, device, gen, num_rays, samples_per_ray):
    """Grid coordinates of samples along camera rays as the cache stage takes
    them: cameras on the sphere of radius 4, rays toward the scene, sorted
    depths between near 2 and far 6, warped by the flagship's contraction."""
    from neural_radiance_caching_tpu_torch.ops import coord

    c = torch.randn((num_rays, 3), generator=gen, device=device)
    origins = 4.0 * c / c.norm(dim=-1, keepdim=True)
    d = -origins / 4.0 + 0.3 * torch.randn((num_rays, 3), generator=gen, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    t, _ = torch.sort(2.0 + 4.0 * torch.rand((num_rays, samples_per_ray), generator=gen,
                                             device=device), dim=-1)
    return (coord.contract_radius_2(origins[:, None] + t[..., None] * d[:, None]) + 2.0) / 4.0


def phase_kernel_rows(torch, device, seed):
    """The row scatter on the run-deduplicated update stream of the flagship
    cache shape (8192 camera rays x 32 samples, 6 levels x 4 taps), one row
    per update, as the dedup stream feeds the skip kernel; and on the same
    updates before the dedup scan (w * ct per tap)."""
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    levels, points, corners, features, num_rows = 6, 262144, 4, 4, 524288
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    x = _primary_sample_points(torch, device, gen, 8192, 32).reshape(-1, 3)
    taps, weights = hashgrid._tap_rows_and_weights(x, None, MATERIAL_LEVELS, num_rows, 3,
                                                   "simplex")
    idx = taps.permute(1, 0, 2).reshape(levels, -1).contiguous()
    w = weights.permute(1, 0, 2).reshape(levels, -1).contiguous()
    del x, taps, weights
    ct = torch.randn((levels, points, features), generator=gen, device=device)
    keep, upd = hashgrid.dedup_runs(idx, w, ct, corners=corners)
    g = (keep[..., None] * upd).contiguous()  # [6, 1,048,576, 4]: one row per update
    raw = _update_rows("leveled", w, ct, corners).contiguous()  # the same, not dedup'd
    kw = dict(num_rows=num_rows, features=features)
    skip_kw = dict(kw, corners=1, skip_zero_w=True)
    ragged = 1_000_003
    rows_kernel = scatter_cuda.scatter_add_rows_leveled
    plain = scatter_cuda.scatter_add_rows_leveled_plain

    before = scatter_cuda.launches["rows"]
    got = rows_kernel(idx, g, **kw)
    got_p = scatter_cuda.scatter_add_rows_padded(idx[0, :ragged], g[0, :ragged], **kw)
    launched = scatter_cuda.launches["rows"] - before
    got_raw = rows_kernel(idx, raw, **kw)
    want = plain(idx, g, **kw)
    limit = SUM_ORDER_TOL * plain(idx, g.abs(), **kw) + 1e-30
    want_p = plain(idx[:1, :ragged], g[:1, :ragged], **kw)[0]
    want_raw = plain(idx, raw, **kw)
    raw_limit = SUM_ORDER_TOL * plain(idx, raw.abs(), **kw) + 1e-30
    skip = scatter_cuda.scatter_add_weighted_leveled(idx, keep, upd, **skip_kw)
    torch.cuda.synchronize()
    max_abs = float((got - want).abs().max())
    raw_abs = float((got_raw - want_raw).abs().max())
    ok = (launched == 2 and bool(((got - want).abs() <= limit).all())
          and bool(((got_p - want_p).abs() <= limit[0]).all())
          and bool(((skip - got).abs() <= 2 * limit).all())
          and bool(((got_raw - want_raw).abs() <= raw_limit).all()))
    share = 1.0 - float(keep.mean())
    del got, got_p, got_raw, want, want_p, want_raw, limit, raw_limit, skip
    ms = _cuda_ms(lambda: rows_kernel(idx, g, **kw))
    plain_ms = _cuda_ms(lambda: plain(idx, g, **kw))
    library_ms = _cuda_ms(_index_add_call(idx, g, num_rows))
    skip_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled(idx, keep, upd, **skip_kw))
    undedup = _alternating_ms({"kernel": lambda: rows_kernel(idx, raw, **kw),
                               "library": _index_add_call(idx, raw, num_rows)})
    undedup_plain_ms = _cuda_ms(lambda: plain(idx, raw, **kw))
    host = {"kernel": _host_ms(torch, lambda: rows_kernel(idx, g, **kw)),
            "library": _host_ms(torch, _index_add_call(idx, g, num_rows))}
    n = levels * points * corners
    # Both streams have one row per update: the same bytes.
    bound_ms, bound_by = _bound(4 * (n + n * features + levels * num_rows * features),
                                n * features)
    print(f"kernel (rows): scatter_add_rows_leveled L={levels} N={n // levels} F={features} "
          f"rows={num_rows} (dedup'd stream of 8192 camera rays x 32 samples: {share:.1%} of "
          f"rows zero) max_abs_err={max_abs:.3e} tol=|err|<={SUM_ORDER_TOL}*sum|g|; "
          f"scatter_add_rows_padded at N={ragged} same tol; the skip kernel on the same "
          f"stream agrees; the same updates before the dedup scan (w*ct per tap) "
          f"max_abs_err={raw_abs:.3e} same tol; launches={launched} {'ok' if ok else 'FAIL'}; "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(index_add_)={library_ms:.4f} "
          f"ratio={ms / library_ms:.3f} skip_same_stream_ms={skip_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) (median of 11, CUDA events); before the "
          f"dedup scan: kernel_ms={undedup['kernel']:.4f} library_ms={undedup['library']:.4f} "
          f"ratio={undedup['kernel'] / undedup['library']:.3f} (medians of 11 in 2 alternating "
          f"turns) plain_ms={undedup_plain_ms:.4f}; host time of one call (no sync): kernel {host['kernel']:.4f} ms, library "
          f"{host['library']:.4f} ms", flush=True)
    if not ok:
        raise AssertionError("the row scatter disagrees with its plain version")
    return dict(launches=launched, max_abs_err=max(max_abs, raw_abs), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                skip_same_stream_ms=skip_ms, undedup_ms=undedup["kernel"],
                undedup_library_ms=undedup["library"], undedup_plain_ms=undedup_plain_ms,
                host_ms=host["kernel"],
                library_host_ms=host["library"])


# The transient reference: 64 bins of 0.25 cover the scene's two-bounce path
# lengths (up to ~11 units) at a narrow width.
TRANSIENT_REF_BATCH = 256
TRANSIENT_REF_BINS = 64
# Transient-model gradients are held per leaf, each hash table split into
# its levels, in relative L2 norm, between the same two readings as the
# cache's: the noise floor below the limit, the planted faults above it.
TRANSIENT_GRAD_REL_L2_TOL = 5e-2
# No loss reaches these parameters of the transient cache model: its
# ambient term is off (use_ambient=False), so neither the shader's ambient
# irradiance head nor the SLF's ambient head is read.
# tests/test_torch_transient_slice.py pins the same set against the JAX
# package's zero gradients.
_TRANSIENT_UNREACHED = {
    "shader.ambient_irradiance_layer.weight", "shader.ambient_irradiance_layer.bias",
    "shader.surface_lf.output_ambient_rgb_layer.weight",
    "shader.surface_lf.output_ambient_rgb_layer.bias",
}


def _narrow_transient(scatter_dedup):
    """The flagship transient structure at reference-phase widths."""
    from neural_radiance_caching_tpu_torch import flagship

    params = _narrow(flagship.flagship_transient_cache_params(scatter_dedup))
    params["shader_params"].update(net_width_irradiance=32, net_width_brdf=32,
                                   net_width_integrated_brdf=32)
    return params


def _transient_ref_config():
    from neural_radiance_caching_tpu_torch import flagship

    return flagship.transient_config(batch_size=TRANSIENT_REF_BATCH, n_bins=TRANSIENT_REF_BINS,
                                     exposure_time=0.25, lr_delay_steps=0)


def _transient_step(torch, device, seed, batch, scatter_dedup, fault=None):
    """One train step of the narrow transient model on `device`; the random
    draws come from a CPU generator, so both devices see the same numbers."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    cfg = _transient_ref_config()
    torch.manual_seed(seed)
    model = flagship.build_flagship_transient_cache_model(
        cfg, _narrow_transient(scatter_dedup), device=device)
    state, _ = train.create_optimizer(cfg, model)
    before = dict(scatter_cuda.launches)
    patch = dict(scatter_add_weighted_leveled=_planted_fault(fault)) if fault else {}
    with _patched(scatter_cuda, **patch):
        rng = torch.Generator().manual_seed(seed + 6)
        _, stats = train.create_train_step(model, cfg)(rng, state, batch.to(device), 0.5)
    losses = {k: float(torch.as_tensor(v).detach()) for k, v in stats["losses"].items()}
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return losses, grads, {k: scatter_cuda.launches[k] - before[k] for k in before}


def phase_transient_reference(torch, device, seed):
    """Same narrow transient model, batch and draws on the GPU and the CPU,
    with the direct and with the run-dedup table-gradient scatter."""
    from neural_radiance_caching_tpu_torch.data import datasets

    batch = datasets.SyntheticSpheres("train", None, _transient_ref_config(), num_images=4,
                                      resolution=32, device="cpu").next_train()
    origins = batch.rays.origins
    nudged = batch.replace(rays=batch.rays.replace(
        origins=torch.nextafter(origins, torch.full_like(origins, float("inf")))))
    tol = TRANSIENT_GRAD_REL_L2_TOL
    gpu_grads = {}
    for dedup in (False, True):
        kind = "leveled_skip" if dedup else "leveled"
        l_cpu, g_cpu, n_cpu = _transient_step(torch, "cpu", seed, batch, dedup)
        reached = [k for k in g_cpu if k not in _TRANSIENT_UNREACHED]
        floor, floor_at = _worst_grad_err(
            _transient_step(torch, "cpu", seed, nudged, dedup)[1], g_cpu, reached)
        l_gpu, g_gpu, n_gpu = _transient_step(torch, device, seed, batch, dedup)
        loss_err = max(abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu)
        err, err_at = _worst_grad_err(g_gpu, g_cpu, reached)
        faults = {f: _worst_grad_err(_transient_step(torch, device, seed, batch, dedup, f)[1],
                                     g_cpu, reached)
                  for f in ("taps rotated", "finest level dropped")}
        finite = all(torch.isfinite(g).all() for g in g_gpu.values())
        ok = (finite and loss_err <= 1e-4 and n_cpu == _launch_counts()
              and n_gpu == _launch_counts(**{kind: 1}) and floor <= tol and err <= tol
              and all(v > tol for v, _ in faults.values()))
        print(f"transient reference ({'scatter_dedup' if dedup else 'direct scatter'}): narrow "
              f"transient cache model, batch {TRANSIENT_REF_BATCH} x {TRANSIENT_REF_BINS} bins, "
              f"same draws, gpu vs cpu: loss rel_err={loss_err:.3e} (tol 1e-4) grad rel_l2_err "
              f"max={err:.3e} at {err_at} (tol {tol}; noise floor, cpu vs cpu with origins "
              f"+1 ulp: {floor:.3e} at {floor_at}; planted in the {kind} kernel "
              + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
              + f", each must exceed the tol) kernel launches gpu={n_gpu} cpu={n_cpu} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("GPU transient path disagrees with the CPU reference path")
        gpu_grads[dedup] = g_gpu
    # Dedup and direct table gradients on the card: the same updates summed
    # in another order, held per level to 1e-5 of the level's largest entry.
    dedup_g, direct_g = _per_level(gpu_grads[True]), _per_level(gpu_grads[False])
    errs = {k: float((dedup_g[k] - direct_g[k]).abs().max()) / float(direct_g[k].abs().max())
            for k in direct_g if ".grid." in k and float(direct_g[k].abs().max()) > 0}
    worst = max(errs, key=errs.get)
    ok = errs[worst] <= 1e-5
    print(f"transient reference (dedup vs direct on the card): table gradients per level, "
          f"max |dedup - direct| / max |direct| = {errs[worst]:.3e} at {worst} (tol 1e-5, "
          f"float32 association order) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("dedup and direct table gradients disagree on the card")


# The per-sample transients of a flagship transient step: rays, samples,
# bins, channels.
TRANSIENT_SHAPE = (2048, 32, 700, 3)


def _time_shift_forms(torch, device, seed):
    """One forward + backward of the transient rendering at the flagship
    shape TRANSIENT_SHAPE for each shift form; the spectral forms held to
    the gather form at 1e-4 of its largest entry."""
    from neural_radiance_caching_tpu_torch.ops import render

    r, s, b, c = TRANSIENT_SHAPE
    gen = torch.Generator(device=device).manual_seed(seed + 11)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    ti = (rand(r, s, b, c) * 0.01).requires_grad_()
    w = rand(r, s) / s
    tdist = torch.sort(2.0 + 4.0 * rand(r, s + 1), dim=-1).values
    extras = {"ray_dists": 2.0 + 4.0 * rand(r, s, 1), "light_dists": 1.0 + 3.0 * rand(r, s, 1)}
    direct = rand(r, s, c)

    def run(form):
        ti.grad = None
        out = render.volumetric_transient_rendering(
            direct, ti, w, w, tdist, 0.0, False, extras=dict(extras, transient_indirect=ti),
            n_bins=b, exposure_time=0.02, shift_form=form)
        out["rgb"].sum().backward()
        return out["rgb"].detach()

    ref = run("gather")
    scale = float(ref.abs().max())
    out = {}
    for form in render.SHIFT_FORMS:
        err = float((run(form) - ref).abs().max()) / scale
        torch.cuda.reset_peak_memory_stats()
        ms = _cuda_ms(lambda f=form: run(f), repeats=5, warmup=1)
        out[form] = dict(ms=ms, rel_err=err, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    ok = all(v["rel_err"] <= 1e-4 for v in out.values())
    return out, ok


def phase_transient_train(torch, device, seed, steps, smi, profile):
    """The full-width flagship transient cache model with the direct backward
    and with scatter_dedup: a checked step each, then 3 warmup and `steps`
    timed steps each, in alternating blocks (direct, dedup, dedup, direct)."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    config = flagship.transient_config()
    t0 = time.perf_counter()
    dataset = datasets.SyntheticSpheres("train", None, config, num_images=4, resolution=64,
                                        device=device)
    batches = [dataset.next_train() for _ in range(8)]
    rng = torch.Generator(device=device).manual_seed(seed + 44)
    runs = {}
    for name, dedup in (("direct", False), ("dedup", True)):
        torch.manual_seed(seed)
        model = flagship.build_flagship_transient_cache_model(
            config, flagship.flagship_transient_cache_params(scatter_dedup=dedup), device=device)
        state, _ = train.create_optimizer(config, model)
        runs[name] = dict(model=model, state=state, step=train.create_train_step(model, config),
                          before={k: v.detach().clone() for k, v in model.state_dict().items()},
                          kind="leveled_skip" if dedup else "leveled", losses=[], times=[],
                          peak=0.0, blocks=[])
    n_params = sum(p.numel() for p in runs["direct"]["model"].parameters())
    setup_s = time.perf_counter() - t0

    # One checked step each: every scatter call of the step against its
    # plain version on the same inputs; the direct step's update stream is
    # kept for the skip-kernel phase.
    capture, checked = {}, {}
    for name, run in runs.items():
        calls = []
        with _patched(scatter_cuda, scatter_add_weighted_leveled=_checking_scatter(
                "leveled", calls, capture if name == "direct" else None)):
            run["state"], stats = run["step"](rng, run["state"], batches[-1], 0.5)
        run["losses"].append(stats["loss"])
        checked[name] = calls
    torch.cuda.synchronize()
    ok = all([c["kind"] for c in checked[n]] == [runs[n]["kind"]] and checked[n][0]["ok"]
             for n in runs)
    print("transient train (checked steps): each scatter of one step against its plain version "
          f"on the same inputs, tol=|err|<={SUM_ORDER_TOL}*sum|w*ct|: "
          + "; ".join(f"{n}: {c['kind']} idx{list(c['shape'])} max_abs_err="
                      f"{c['max_abs_err']:.3e} {'ok' if c['ok'] else 'FAIL'}"
                      for n, calls in checked.items() for c in calls)
          + f" (expected one leveled call without dedup, one leveled_skip with it) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version on the transient path")

    warmup = 3
    for run in runs.values():
        for i in range(warmup):
            run["state"], stats = run["step"](rng, run["state"], batches[i % len(batches)], 0.5)
            run["losses"].append(stats["loss"])
    torch.cuda.synchronize()
    block = max(1, steps // 2)
    for bi, name in enumerate(("direct", "dedup", "dedup", "direct")):
        run = runs[name]
        torch.cuda.reset_peak_memory_stats()
        scatter_cuda.reset_launch_count()
        t0 = time.perf_counter()
        for i in range(block):
            run["state"], stats = run["step"](rng, run["state"],
                                              batches[(bi * block + i) % len(batches)], 0.5)
            run["losses"].append(stats["loss"])
        torch.cuda.synchronize()
        run["times"].append((time.perf_counter() - t0) / block)
        run["blocks"].append(dict(scatter_cuda.launches))
        run["peak"] = max(run["peak"], torch.cuda.max_memory_allocated() / 2**30)

    result = {}
    all_ok = True
    for name, run in runs.items():
        losses = [float(v) for v in run["losses"]]
        finite = all(v == v and abs(v) != float("inf") for v in losses)
        unchanged = {k for k, v in run["model"].state_dict().items()
                     if torch.equal(v, run["before"][k])}
        pinned = _launch_counts(**{run["kind"]: block})
        ok = finite and unchanged == _TRANSIENT_UNREACHED and all(
            b == pinned for b in run["blocks"])
        all_ok &= ok
        dt = statistics.mean(run["times"])
        result[name] = dict(launches=sum(b[run["kind"]] for b in run["blocks"]), step_ms=dt * 1e3,
                            rays_per_s=config.batch_size / dt, peak_gib=run["peak"],
                            max_abs_err=checked[name][0]["max_abs_err"])
        print(f"transient train ({name}{', scatter_dedup' if name == 'dedup' else ''}): flagship "
              f"transient cache model ({n_params} params) batch {config.batch_size} x "
              f"{config.n_bins} bins, SyntheticSpheres 4x64^2, setup {setup_s:.1f}s; {warmup} "
              f"warmup + {2 * block} timed steps in 2 blocks alternating with the other run: "
              f"step_ms={dt * 1e3:.2f} (blocks {', '.join(f'{t * 1e3:.2f}' for t in run['times'])})"
              f" rays_per_s={config.batch_size / dt:.1f} peak {run['peak']:.2f} GiB on [{smi}]; "
              f"losses finite={finite} first={losses[0]:.5f} last={losses[-1]:.5f}; "
              f"{len(run['before']) - len(unchanged)}/{len(run['before'])} param tensors changed, "
              f"unchanged={sorted(unchanged)} (expected the {len(_TRANSIENT_UNREACHED)} no loss "
              f"reaches); scatter launches per block={run['blocks']} (expected {pinned}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    if not all_ok:
        raise AssertionError("transient train phase failed")

    forms, ok = _time_shift_forms(torch, device, seed)
    print("transient shift forms: one forward + backward of volumetric_transient_rendering at "
          f"{list(TRANSIENT_SHAPE)}: " + "; ".join(
              f"{f} {v['ms']:.2f} ms (peak {v['peak_gib']:.2f} GiB, rel_err vs gather "
              f"{v['rel_err']:.2e})" for f, v in forms.items())
          + f" (median of 5, CUDA events; tol 1e-4) on [{smi}] {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("the transient shift forms disagree")
    result["shift_forms"] = forms
    if profile:
        path = str(profile)
        stem, dot, ext = path.rpartition(".")
        run = runs["direct"]
        _profile(torch, run["step"], run["state"], rng, batches,
                 f"{stem}.transient.{ext}" if dot else path + ".transient", steps=2)
    return result, capture


def phase_kernel_skip(torch, device, capture):
    """The skip-zero-weight instance on the dedup'd stream of the transient
    path's own updates (6 levels x 2048 rays x 32 samples x 4 taps), against
    its plain version, with NaN rows planted under the zero weights; both
    scatter routes (dedup prep + skip kernel, direct kernel) timed."""
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    idx, w, ct = capture["idx"], capture["w"], capture["ct"]
    num_rows, features, corners = capture["num_rows"], capture["features"], capture["corners"]
    levels, n = idx.shape
    keep, rows = hashgrid.dedup_runs(idx, w, ct, corners=corners)
    kept = int(keep.sum())
    share = 1.0 - kept / keep.numel()
    nan_rows = torch.where(keep[..., None] == 0, torch.full_like(rows, float("nan")), rows)
    kw = dict(num_rows=num_rows, features=features, corners=1, skip_zero_w=True)
    direct_kw = dict(num_rows=num_rows, features=features, corners=corners)
    got = scatter_cuda.scatter_add_weighted_leveled(idx, keep, nan_rows, **kw)
    want = scatter_cuda.scatter_add_weighted_leveled_plain(idx, keep, nan_rows, **kw)
    direct = scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **direct_kw)
    limit = SUM_ORDER_TOL * _abs_sum_bound(idx, keep, rows, num_rows, 1, skip_zero_w=True) + 1e-30
    direct_limit = SUM_ORDER_TOL * _abs_sum_bound(idx, w, ct, num_rows, corners) + 1e-30
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got).all())
    max_abs = float((got - want).abs().max())
    ok = (finite and bool(((got - want).abs() <= limit).all())
          and bool(((got - direct).abs() <= direct_limit).all()))
    dedup_err = float((got - direct).abs().max())
    del got, want, direct, nan_rows, limit, direct_limit

    ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled(idx, keep, rows, **kw))
    plain_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled_plain(
        idx, keep, rows, **kw))
    offsets = torch.arange(levels, device=idx.device, dtype=torch.int64)[:, None] * num_rows
    kept_mask = keep != 0
    kept_idx = (idx.to(torch.int64) + offsets)[kept_mask]
    kept_rows = rows[kept_mask].contiguous()
    library_ms = _cuda_ms(lambda: torch.zeros(levels * num_rows, features, device=device)
                          .index_add_(0, kept_idx, kept_rows))
    dedup_route_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled(
        idx, *hashgrid.dedup_runs(idx, w, ct, corners=corners), **kw))
    direct_ms = _cuda_ms(lambda: scatter_cuda.scatter_add_weighted_leveled(idx, w, ct, **direct_kw))
    bound_ms, bound_by = _bound(4 * (levels * n + kept * (1 + features)
                                     + levels * num_rows * features), 2 * kept * features)
    print(f"kernel (skip): scatter_add_weighted_leveled(skip_zero_w=True) on the dedup'd stream "
          f"of the transient path's updates, idx{list(idx.shape)} F={features} rows={num_rows}: "
          f"{share:.1%} of updates have weight 0 ({kept} kept); NaN rows planted under them, "
          f"output finite={finite}; max_abs_err vs plain={max_abs:.3e} "
          f"(tol=|err|<={SUM_ORDER_TOL}*sum|w*row|), vs the direct kernel {dedup_err:.3e} "
          f"(tol {SUM_ORDER_TOL}*sum|w*ct|) {'ok' if ok else 'FAIL'}; kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms(index_add_ of the kept rows)={library_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}); routes: dedup prep + skip kernel "
          f"{dedup_route_ms:.4f} ms vs direct kernel {direct_ms:.4f} ms (median of 11, CUDA "
          f"events)", flush=True)
    if not ok:
        raise AssertionError("the skip kernel disagrees with its plain version")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, zero_weight_share=share,
                dedup_route_ms=dedup_route_ms, direct_route_ms=direct_ms,
                direct_max_abs_err=dedup_err)


# The eval reference: a held-out 16^2 view in chunks of 96 rays (96, 96, 64:
# a ragged last chunk), 2 repeats per chunk.
EVAL_REF_RES = 16
EVAL_REF_CHUNK = 96
EVAL_REF_REPEATS = 2
# Eval outputs are held per key (rgb, acc, the distance statistics, every
# extra, the rgb variance) in relative L2 norm over the view. Each limit sits
# between the two readings the phase takes in every run: the noise floor (the
# CPU path against itself with the ray origins moved by one float32 ulp) below
# it, and two encoder faults planted in the GPU forward above it. The
# material model's outputs average secondary rays, whose directions a
# rounding error in a normal turns, so its floor and limit are higher.
EVAL_REL_L2_TOL = {"cache": 2e-2, "material": 0.2, "transient": 2e-2}


def _eval_ref_model(torch, kind, seed, device):
    """(config, model) of the narrow `kind` model of phases 7-9, every
    parameter drawn from U(-0.5, 0.5) by a CPU generator, then moved: the
    builders' initial hash tables are near zero, so an encoder fault would
    not show in their renders."""
    from neural_radiance_caching_tpu_torch import flagship

    chunk = dict(render_chunk_size=EVAL_REF_CHUNK)
    if kind == "cache":
        cfg = flagship.cache_config(**chunk)
        model = flagship.build_flagship_cache_model(
            cfg, _narrow(flagship.flagship_cache_params()), device="cpu")
    elif kind == "material":
        cfg = flagship.material_config(**chunk)
        model = flagship.build_flagship_material_model(cfg, _narrow_material(), device="cpu")
    else:
        cfg = _transient_ref_config()
        cfg.render_chunk_size = EVAL_REF_CHUNK
        model = flagship.build_flagship_transient_cache_model(cfg, _narrow_transient(False),
                                                              device="cpu")
    gen = torch.Generator().manual_seed(seed + 12)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.rand(p.shape, generator=gen) - 0.5)
    return cfg, model.to(device)


def _planted_encoder_fault(fault):
    """The hash-grid encoder forward with a deliberate fault, for the eval
    reference's check that its limits would catch one."""
    from neural_radiance_caching_tpu_torch.ops import hashgrid

    real = hashgrid.multires_grid_encode

    def encode(x, hash_tables, dense_pool, **kw):
        f = real(x, hash_tables, dense_pool, **kw)
        width = f.shape[-1] // len(kw["grid_sizes"])
        if fault == "finest level dropped":
            keep = f.new_ones(f.shape[-1])
            keep[-width:] = 0.0
            return f * keep
        return f.unflatten(-1, (-1, width)).flip(-2).flatten(-2)  # "levels reversed"

    return encode


def _eval_render(torch, kind, seed, device, view, fault=None):
    """The held-out view rendered by the narrow `kind` model on `device`
    through create_render_fn + render_image, the draws from a CPU generator
    (the same numbers on both devices); returns (images, launches)."""
    from neural_radiance_caching_tpu_torch.engine import renderer
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    cfg, model = _eval_ref_model(torch, kind, seed, device)
    patch = dict(multires_grid_encode=_planted_encoder_fault(fault)) if fault else {}
    before = dict(scatter_cuda.launches)
    with _patched(hashgrid, **patch):
        images = renderer.render_image(
            train.create_render_fn(model), view.rays.to(device),
            torch.Generator().manual_seed(seed + 13), cfg, height=EVAL_REF_RES,
            width=EVAL_REF_RES, render_repeats=EVAL_REF_REPEATS, device=device)
    return images, {k: scatter_cuda.launches[k] - before[k] for k in before}


def _worst_output_err(images, ref):
    """(worst relative L2 error over the outputs, its key); an output that is
    zero in `ref` is held in absolute L2."""
    import numpy as np

    errs = {}
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        d = float(np.linalg.norm(np.asarray(images[k], np.float64) - r))
        scale = float(np.linalg.norm(r))
        errs[k] = d / scale if scale > 0 else d
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def phase_eval_reference(torch, device, seed):
    """The narrow cache, material and transient models of phases 7-9, the
    same weights and draws on the GPU and the CPU, each rendering a held-out
    view through create_render_fn + render_image with a ragged last chunk
    and 2 repeats; every output compared, no scatter launched."""
    from neural_radiance_caching_tpu_torch.data import datasets

    for kind in ("cache", "material", "transient"):
        cfg, _ = _eval_ref_model(torch, kind, seed, "cpu")
        view = datasets.SyntheticSpheres("test", None, cfg, num_images=2, resolution=EVAL_REF_RES,
                                         device="cpu").generate_ray_batch(0)
        origins = view.rays.origins
        nudged = view.replace(rays=view.rays.replace(
            origins=torch.nextafter(origins, torch.full_like(origins, float("inf")))))
        ref, n_cpu = _eval_render(torch, kind, seed, "cpu", view)
        floor, floor_at = _worst_output_err(_eval_render(torch, kind, seed, "cpu", nudged)[0], ref)
        images, n_gpu = _eval_render(torch, kind, seed, device, view)
        err, err_at = _worst_output_err(images, ref)
        faults = {f: _worst_output_err(_eval_render(torch, kind, seed, device, view, f)[0], ref)
                  for f in ("finest level dropped", "levels reversed")}
        tol = EVAL_REL_L2_TOL[kind]
        ok = (sorted(images) == sorted(ref) and "rgb_variance" in ref
              and n_cpu == n_gpu == _launch_counts() and floor <= tol and err <= tol
              and all(v > tol for v, _ in faults.values()))
        print(f"eval reference ({kind}): narrow {kind} model, held-out {EVAL_REF_RES}^2 view in "
              f"chunks of {EVAL_REF_CHUNK} (last one ragged), {EVAL_REF_REPEATS} repeats, same "
              f"weights and draws, gpu vs cpu over {len(ref)} outputs: rel_l2_err max={err:.3e} "
              f"at {err_at} (tol {tol}; noise floor, cpu vs cpu with origins +1 ulp: "
              f"{floor:.3e} at {floor_at}; planted in the gpu encoder forward "
              + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
              + f", each must exceed the tol) scatter launches gpu={n_gpu} cpu={n_cpu} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"GPU {kind} eval render disagrees with the CPU reference")


GATE_STEPS = 200
# The JAX package's gate reading on a TPU v5e in round 5 (BENCH_r05.json).
JAX_GATE_DB = 23.69


def phase_gate(torch, device, seed, smi):
    """The 200-step trained-PSNR gate of the full-width flagship cache model:
    a fresh build, 200 steps at the gate's learning rate on the bench's
    training set (8 views at 128^2), then view 0 of the held-out 64^2 set."""
    import numpy as np

    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.engine import trainer
    from neural_radiance_caching_tpu_torch.ops import image, scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    config = flagship.cache_config()
    torch.manual_seed(seed)
    model = flagship.build_flagship_cache_model(config, device=device)
    dataset = datasets.SyntheticSpheres("train", None, config, num_images=8, resolution=128,
                                        device=device)
    scatter_cuda.reset_launch_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db = flagship.trained_psnr_gate(model, config, dataset, steps=GATE_STEPS)
    gate_s = time.perf_counter() - t0
    launches = dict(scatter_cuda.launches)
    # The same held-out view and draws through render_test_view and the
    # eval metrics: their PSNR is the gate's before rounding.
    test = datasets.SyntheticSpheres("test", None, config, num_images=2, resolution=64,
                                     device=device)
    rendering, batch = trainer.render_test_view(
        train.create_render_fn(model), test, 0, torch.Generator(device=device).manual_seed(7),
        config)
    metrics = trainer.compute_eval_metrics(
        rendering, batch, test.height, test.width, config, image.MetricHarness(device=device),
        lambda x: np.clip(x, 0, 1))
    ok = (launches == _launch_counts(leveled=GATE_STEPS)
          and abs(metrics["psnr"] - db) <= 0.005 + 1e-6 and _lpips_ok(metrics))
    print(f"gate: flagship cache model, {GATE_STEPS} steps from a fresh build (lr 0.01 -> 0.003, "
          f"50-step delay, 16 batches of 8192 drawn ahead, SyntheticSpheres 8x128^2), then view "
          f"0 of the held-out 2x64^2 set: trained_psnr={db:.2f} dB (floor "
          f"{flagship.TRAINED_PSNR_FLOOR}; the JAX package reached {JAX_GATE_DB} dB on a TPU v5e "
          f"in round 5, BENCH_r05.json: a quality reference, not a speed target) "
          f"psnr={metrics['psnr']:.4f} ssim={metrics['ssim']:.4f} {_lpips_text(metrics)} "
          f"(compute_eval_metrics of the same view); gate wall time {gate_s:.1f}s on [{smi}]; "
          f"scatter launches={launches} "
          f"(expected leveled {GATE_STEPS}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("gate phase failed")
    if db < flagship.TRAINED_PSNR_FLOOR:
        raise AssertionError(f"trained PSNR {db} dB is below the floor of "
                             f"{flagship.TRAINED_PSNR_FLOOR} dB")
    return dict(trained_psnr_db=db, floor_db=flagship.TRAINED_PSNR_FLOOR, psnr=metrics["psnr"],
                ssim=metrics["ssim"], lpips=metrics["lpips"], gate_s=gate_s,
                launches=launches["leveled"])


def _first_chunk(torch, render_fn, rays, chunk, device):
    """The render function alone on the first `chunk` rays: (whether its
    outputs are finite before render_image's nan_to_num, its device time in
    ms, median of 3 by CUDA events)."""
    from neural_radiance_caching_tpu_torch.engine import renderer

    first = renderer._chunk_rays(rays, slice(0, chunk))

    def run():
        return render_fn(torch.Generator(device=device).manual_seed(11), 1.0, first)

    finite = all(bool(torch.isfinite(v).all()) for v in run().values()
                 if isinstance(v, torch.Tensor))
    return finite, _cuda_ms(run, repeats=3, warmup=1)


def _eval_render_stage(torch, model, config, test, device, n_images):
    """bench_eval_render of `model` on view 0 of `test` with its peak memory,
    after the render function alone on the first chunk; one line of text."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.parallel import train

    finite, chunk_ms = _first_chunk(torch, train.create_render_fn(model),
                                    test.generate_ray_batch(0).rays, config.render_chunk_size,
                                    device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, d = flagship.bench_eval_render(model, config, test, n_images=n_images)
    d.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30, render_fn_ms=chunk_ms,
             finite=finite)
    full, fast = d["image_secs"], d["rgb_only_image_secs"]
    text = (f"{test.height}^2 view = {d['rays_per_image']} rays in chunks of "
            f"{d['render_chunk_size']}, 1 warmup + {n_images} timed images: full extras s/image "
            f"median {statistics.median(full):.4f} (min {min(full):.4f}, max {max(full):.4f}) = "
            f"{d['rays_per_sec']:.0f} rays/s (mean), {d['ms_per_ray']:.3e} ms/ray; rgb-only "
            f"s/image median {statistics.median(fast):.4f} (min {min(fast):.4f}, max "
            f"{max(fast):.4f}) = {d['rgb_only_rays_per_sec']:.0f} rays/s; the render function "
            f"alone on one chunk (device, CUDA events, median of 3) {chunk_ms:.2f} ms; peak "
            f"{d['peak_gib']:.2f} GiB; untrained_psnr {d['untrained_psnr']:.2f} dB (a sanity "
            f"anchor); raw outputs finite={finite}")
    return d, text


def phase_eval_render(torch, device, seed, smi):
    """Eval renders of the four full-width flagship models (untrained, fresh
    builds) through bench_eval_render: the cache model on the 128^2 test
    view (the JAX bench's render stage), the material model on a held-out
    64^2 view in chunks of 1024 and then as one chunk of 4096 if it fits, the
    transient cache model on a held-out 64^2 view as one chunk of 4096 rays x
    700 bins, and the transient material model on that view in chunks of
    1024."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    stages = (
        ("cache", flagship.cache_config(), flagship.build_flagship_cache_model, 128, 3),
        ("material", flagship.material_config(render_chunk_size=1024),
         flagship.build_flagship_material_model, 64, 2),
        ("transient", flagship.transient_config(render_chunk_size=4096),
         flagship.build_flagship_transient_cache_model, 64, 2),
        ("transient_material", flagship.transient_material_config(render_chunk_size=1024),
         flagship.build_flagship_transient_material_model, 64, 2),
    )
    out = {}
    scatter_cuda.reset_launch_count()
    for name, config, build, res, n_images in stages:
        torch.manual_seed(seed)
        model = build(config, device=device)
        test = datasets.SyntheticSpheres("test", None, config, num_images=2, resolution=res,
                                         device=device)
        out[name], text = _eval_render_stage(torch, model, config, test, device, n_images)
        print(f"eval render ({name}): flagship {name} model (untrained), {text} on [{smi}]",
              flush=True)
        if name == "material":
            # The JAX notes cap material renders at chunk 1024 (a 34 GB buffer at
            # 8192); whether the whole view fits as one chunk on this card.
            config.render_chunk_size = 4096
            try:
                out["material_one_chunk"], text = _eval_render_stage(
                    torch, model, config, test, device, 1)
            except torch.cuda.OutOfMemoryError:
                text = "did not fit"
                torch.cuda.empty_cache()
            print(f"eval render (material, one chunk): {text} on [{smi}]", flush=True)
        del model

    launches = dict(scatter_cuda.launches)
    ok = launches == _launch_counts() and all(v["finite"] for v in out.values())
    print(f"eval render: scatter launches over every eval render={launches} (expected none) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("eval render phase failed")
    return out


# The transient material reference: the transient reference's 64 bins of
# 0.25, 128 rays x 32 secondary rays, each secondary ray resampled to one
# point (the flagship's resample_secondary).
TRANSIENT_MATERIAL_REF_BATCH = 128
# Transient-material gradients are held per leaf, each hash table split into
# its levels, in relative L2 norm, between the same two readings as the
# material model's: the noise floor (3.46e-2 on the CPU path) below the
# limit, the planted leveled-kernel faults (1.0 and more) above it.
TRANSIENT_MATERIAL_GRAD_REL_L2_TOL = 0.1
# No loss reaches these parameters of the transient material model: the
# learnable light replaces the material shader's own light power; the light
# sampler's outputs feed only the (unused on this path) light importance
# sampler, under a stop-gradient; the light source's position, shift and
# dark-level offsets are constants while their optimize_* flags are off; the
# cache shader's ambient heads are off. tests/test_torch_transient_material_
# slice.py pins the same set against the JAX package's zero gradients.
_TRANSIENT_MATERIAL_UNREACHED = {
    "shader.light_power",
    "shader.learnable_light.light_source_offset", "shader.learnable_light.transient_shift_offset",
    "shader.learnable_light.dark_level_offset",
    "light_sampler.layers.0.weight", "light_sampler.layers.0.bias",
    "light_sampler.layers.1.weight", "light_sampler.layers.1.bias",
    "light_sampler.output_layer.weight", "light_sampler.output_layer.bias",
    "light_sampler.grid.dense_levels", "light_sampler.grid.hash_levels",
    "cache.shader.ambient_irradiance_layer.weight", "cache.shader.ambient_irradiance_layer.bias",
    "cache.shader.surface_lf.output_ambient_rgb_layer.weight",
    "cache.shader.surface_lf.output_ambient_rgb_layer.bias",
}
# Scatter launches per transient material train step: one leveled backward
# per encoder a loss reaches, the cache's primary samples (512 x 32 points),
# its secondary samples (512 x 32 secondary rays x 32 samples = 524,288,
# below the planes layout's 2^20) and the material grid (512 points). The
# light sampler's grid gets no gradient, and the debias forward no graph.
_TRANSIENT_MATERIAL_LAUNCHES_PER_STEP = {"leveled": 3, "leveled_skip": 0, "planes": 0, "rows": 0}


def _narrow_transient_material():
    """The flagship transient material structure at reference-phase widths:
    the narrow transient cache of phase 9 with secondary-ray resampling, and
    the narrow light sampler and material shader of phase 8."""
    from neural_radiance_caching_tpu_torch import flagship

    strategy = ((0, 0, 16), (1, 1, 16), (2, 2, 16))
    cache = _narrow_transient(False)
    cache["sampler_params"]["sampling_strategy"] = strategy
    cache["train_sampling_strategy"] = cache["render_sampling_strategy"] = strategy
    return _narrow_material_shader(flagship.flagship_transient_material_params(cache), strategy)


def _transient_material_ref_config():
    from neural_radiance_caching_tpu_torch import flagship

    cfg = flagship.transient_material_config(
        batch_size=TRANSIENT_MATERIAL_REF_BATCH, n_bins=TRANSIENT_REF_BINS, exposure_time=0.25,
        lr_delay_steps=0)
    return dataclasses.replace(cfg, extra_losses=flagship.trainer_consistency_losses(cfg))


def _transient_material_step(torch, device, seed, batch, fault=None):
    """One train step of the narrow transient material model, under the
    trainer's consistency binding, on `device`; the random draws come from a
    CPU generator, so both devices see the same numbers."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    cfg = _transient_material_ref_config()
    torch.manual_seed(seed)
    model = flagship.build_flagship_transient_material_model(
        cfg, _narrow_transient_material(), device=device)
    state, _ = train.create_optimizer(cfg, model)
    before = dict(scatter_cuda.launches)
    patch = dict(scatter_add_weighted_leveled=_planted_fault(fault)) if fault else {}
    with _patched(scatter_cuda, **patch):
        rng = torch.Generator().manual_seed(seed + 7)
        _, stats = train.create_train_step(model, cfg)(rng, state, batch.to(device), 0.5)
    losses = {k: float(torch.as_tensor(v).detach()) for k, v in stats["losses"].items()}
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
    return losses, grads, {k: scatter_cuda.launches[k] - before[k] for k in before}


def phase_transient_material_reference(torch, device, seed):
    """Same narrow transient material model, batch and draws on the GPU and
    the CPU, with the consistency loss under the trainer's binding."""
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.parallel import extra_losses

    cfg = _transient_material_ref_config()
    batch = datasets.SyntheticSpheres("train", None, cfg, num_images=4, resolution=32,
                                      device="cpu").next_train()
    origins = batch.rays.origins
    nudged = batch.replace(rays=batch.rays.replace(
        origins=torch.nextafter(origins, torch.full_like(origins, float("inf")))))
    l_cpu, g_cpu, n_cpu = _transient_material_step(torch, "cpu", seed, batch)
    reached = [k for k in g_cpu if k not in _TRANSIENT_MATERIAL_UNREACHED]
    floor, floor_at = _worst_grad_err(
        _transient_material_step(torch, "cpu", seed, nudged)[1], g_cpu, reached)
    l_gpu, g_gpu, n_gpu = _transient_material_step(torch, device, seed, batch)
    loss_errs = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    loss_err = max(loss_errs.values())
    err, err_at = _worst_grad_err(g_gpu, g_cpu, reached)
    faults = {f: _worst_grad_err(_transient_material_step(torch, device, seed, batch, f)[1],
                                 g_cpu, reached)
              for f in ("taps rotated", "finest level dropped")}
    finite = all(torch.isfinite(g).all() for g in g_gpu.values())
    tol = TRANSIENT_MATERIAL_GRAD_REL_L2_TOL
    ok = (finite and extra_losses.CONSISTENCY in l_cpu and loss_err <= 1e-3
          and n_cpu == _launch_counts() and n_gpu == _TRANSIENT_MATERIAL_LAUNCHES_PER_STEP
          and floor <= tol and err <= tol and all(v > tol for v, _ in faults.values()))
    print(f"transient material reference: narrow transient material model, batch "
          f"{TRANSIENT_MATERIAL_REF_BATCH} x {TRANSIENT_REF_BINS} bins x 32 secondary rays, the "
          f"trainer's consistency binding, same draws, gpu vs cpu: loss rel_err max="
          f"{loss_err:.3e} (tol 1e-3; " + ", ".join(f"{k} {v:.2e}" for k, v in loss_errs.items())
          + f") grad rel_l2_err max={err:.3e} at {err_at} (tol {tol}; noise floor, cpu vs cpu "
          f"with origins +1 ulp: {floor:.3e} at {floor_at}; planted in the leveled kernel "
          + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
          + f", each must exceed the tol) kernel launches gpu={n_gpu} cpu={n_cpu} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("GPU transient material path disagrees with the CPU reference path")
    return dict(loss_rel_err=loss_err, grad_rel_l2_err=err, noise_floor=floor,
                faults={f: v for f, (v, _) in faults.items()}, tol=tol)


def phase_transient_material_train(torch, device, seed, steps, smi, profile=None):
    """The full-width flagship transient material model in both forms (the
    bench's step, the trainer's consistency binding): a checked step each,
    then 3 warmup and `steps` timed steps each with gradient checkpointing in
    alternating blocks (bench, trainer, trainer, bench), then one step each
    without checkpointing for its peak memory."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import extra_losses, train

    per_step = _TRANSIENT_MATERIAL_LAUNCHES_PER_STEP
    t0 = time.perf_counter()
    runs = {}
    # The bench's step has no extra loss; the staged trainer binds the
    # consistency loss.
    bench_config = flagship.transient_material_config()
    for name, extra in (("bench", {}),
                        ("trainer", flagship.trainer_consistency_losses(bench_config))):
        config = dataclasses.replace(bench_config, extra_losses=extra)
        torch.manual_seed(seed)
        model = flagship.build_flagship_transient_material_model(config, device=device)
        state, _ = train.create_optimizer(config, model)
        runs[name] = dict(config=config, model=model, state=state,
                          step=train.create_train_step(model, config),
                          before={k: v.detach().clone() for k, v in model.state_dict().items()},
                          losses=[], consistency=[], times=[], peak=0.0, blocks=[])
    config = runs["bench"]["config"]
    dataset = datasets.SyntheticSpheres("train", None, config, num_images=4, resolution=64,
                                        device=device)
    batches = [dataset.next_train() for _ in range(8)]
    rng = torch.Generator(device=device).manual_seed(seed + 45)
    n_params = sum(p.numel() for p in runs["bench"]["model"].parameters())
    setup_s = time.perf_counter() - t0

    def step(run, batch):
        run["state"], stats = run["step"](rng, run["state"], batch, 0.5)
        run["losses"].append(stats["loss"])
        if extra_losses.CONSISTENCY in stats["losses"]:
            run["consistency"].append(stats["losses"][extra_losses.CONSISTENCY].detach())

    # One checked step each: every scatter call of the step against its
    # plain version on the same inputs.
    checked = {}
    for name, run in runs.items():
        calls = []
        with _patched(scatter_cuda,
                      scatter_add_weighted_leveled=_checking_scatter("leveled", calls),
                      scatter_add_weighted_planes=_checking_scatter("planes", calls)):
            step(run, batches[-1])
        checked[name] = calls
    torch.cuda.synchronize()
    kinds = {n: {k: sum(c["kind"] == k for c in calls) for k in per_step}
             for n, calls in checked.items()}
    ok = all(kinds[n] == per_step and all(c["ok"] for c in checked[n]) for n in runs)
    print("transient material train (checked steps): each scatter of one step against its plain "
          f"version on the same inputs, tol=|err|<={SUM_ORDER_TOL}*sum|w*ct|: "
          + "; ".join(f"{n}: {c['kind']} idx{list(c['shape'])} max_abs_err="
                      f"{c['max_abs_err']:.3e} {'ok' if c['ok'] else 'FAIL'}"
                      for n, calls in checked.items() for c in calls)
          + f" (calls {kinds}, expected {per_step} in each form) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version on the transient "
                             "material path")

    warmup = 3
    for run in runs.values():
        for i in range(warmup):
            step(run, batches[i % len(batches)])
    torch.cuda.synchronize()
    block = max(1, steps // 2)
    for bi, name in enumerate(("bench", "trainer", "trainer", "bench")):
        run = runs[name]
        torch.cuda.reset_peak_memory_stats()
        scatter_cuda.reset_launch_count()
        t0 = time.perf_counter()
        for i in range(block):
            step(run, batches[(bi * block + i) % len(batches)])
        torch.cuda.synchronize()
        run["times"].append((time.perf_counter() - t0) / block)
        run["blocks"].append(dict(scatter_cuda.launches))
        run["peak"] = max(run["peak"], torch.cuda.max_memory_allocated() / 2**30)

    # One more step each without checkpointing: its peak memory.
    for run in runs.values():
        run["config"].gradient_checkpointing = False
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        step(run, batches[0])
        torch.cuda.synchronize()
        run["nockpt_ms"] = (time.perf_counter() - t1) * 1e3
        run["nockpt_peak"] = torch.cuda.max_memory_allocated() / 2**30
        run["config"].gradient_checkpointing = True

    result, all_ok = {}, True
    pinned = {k: n * block for k, n in per_step.items()}
    for name, run in runs.items():
        losses = [float(v) for v in run["losses"]]
        consistency = [float(v) for v in run["consistency"]]
        finite = all(v == v and abs(v) != float("inf") for v in losses + consistency)
        unchanged = {k for k, v in run["model"].state_dict().items()
                     if torch.equal(v, run["before"][k])}
        ok = (finite and unchanged == _TRANSIENT_MATERIAL_UNREACHED
              and bool(consistency) == (name == "trainer")
              and all(b == pinned for b in run["blocks"]))
        all_ok &= ok
        dt = statistics.mean(run["times"])
        result[name] = dict(
            launches=sum(b["leveled"] for b in run["blocks"]), step_ms=dt * 1e3,
            block_ms=[t * 1e3 for t in run["times"]], rays_per_s=config.batch_size / dt,
            peak_gib=run["peak"], nockpt_ms=run["nockpt_ms"], nockpt_peak_gib=run["nockpt_peak"],
            max_abs_err=max(c["max_abs_err"] for c in checked[name]))
        cons_text = (f" consistency first={consistency[0]:.5f} last={consistency[-1]:.5f};"
                     if consistency else "")
        print(f"transient material train ({name}): flagship transient material model "
              f"({n_params} params) batch {config.batch_size} x {config.n_bins} bins x 32 "
              f"secondary rays, SyntheticSpheres 4x64^2, setup {setup_s:.1f}s; {warmup} warmup + "
              f"{2 * block} timed steps with gradient checkpointing in 2 blocks alternating with "
              f"the other form: step_ms={dt * 1e3:.2f} (blocks "
              f"{', '.join(f'{t * 1e3:.2f}' for t in run['times'])}) rays_per_s="
              f"{config.batch_size / dt:.1f} peak {run['peak']:.2f} GiB; one step without "
              f"checkpointing: {run['nockpt_ms']:.1f} ms, peak {run['nockpt_peak']:.2f} GiB; on "
              f"[{smi}]; losses finite={finite} first={losses[0]:.5f} last={losses[-1]:.5f};"
              f"{cons_text} {len(run['before']) - len(unchanged)}/{len(run['before'])} param "
              f"tensors changed, unchanged={sorted(unchanged)} (expected the "
              f"{len(_TRANSIENT_MATERIAL_UNREACHED)} no loss reaches); scatter launches per "
              f"block={run['blocks']} (expected {pinned}) {'ok' if ok else 'FAIL'}", flush=True)
    if not all_ok:
        raise AssertionError("transient material train phase failed")
    if profile:
        path = str(profile)
        stem, dot, ext = path.rpartition(".")
        run = runs["trainer"]
        _profile(torch, run["step"], run["state"], rng, batches,
                 f"{stem}.transient_material.{ext}" if dot else path + ".transient_material",
                 steps=2)
    return result


# The gin stages of the staged trainer (`engine/trainer.Trainer`, the
# `train_with_trainer` entry point). The cache stage: on
# configs/synthetic_spheres.gin its final proposal level runs the leveled
# kernel once per step; on the full-width configs/ngp_yobo.gin the density
# normals take the plain encoder (second order) and no kernel runs. The
# material stage (README's second stage, material_light_from_scratch with
# resampling): on synthetic_spheres.gin the leveled kernel runs for the
# cache's primary samples, its secondary samples, the "geometry"
# re-evaluation of material_smoothness and the light sampler's grid, which
# light_sampling trains; on ngp_yobo.gin none (density normals, no light
# sampler grid).
TRAINER_REF_CONFIG = "configs/synthetic_spheres.gin"
TRAINER_CONFIG = "configs/ngp_yobo.gin"
# The bindings that run a scene config without its data (the JAX trainer
# test's).
TRAINER_BINDINGS = ("Config.dataset_loader = 'synthetic_spheres'", "Config.near = 0.2")
TRAINER_CACHE_STAGE = ("Trainer.stage = 'cache'",)
# The material stage on synthetic_spheres.gin, with the nerf_ngp_yobo.gin
# family's weights of what spheres leaves off (smoothness, consistency, the
# secondary rays' stop-gradient weights) and the secondary sampler's
# interlevel term, so that every ported term has a value and a gradient.
TRAINER_MATERIAL_STAGE = (
    "Trainer.stage = 'material_light_from_scratch'", "Trainer.resample = True",
    "Config.material_smoothness_weight_albedo = 0.0001",
    "Config.material_smoothness_weight_other = 0.0001",
    "Config.cache_consistency_loss_weight = 0.1",
    "Config.material_ray_sampler_interlevel_loss_mult = 1.0",
    "MaterialMLP.stopgrad_shading_weight = 1e-2", "MaterialMLP.stopgrad_cache_weight = (1e2, 1e-4)")
_TRAINER_MATERIAL_LAUNCHES_PER_STEP = 4
# The hotdog's orientation loss (nerf_ngp_yobo_hotdog.gin), added to that
# stage in phase 21's second step. With the 1e2 weight on the secondary rays'
# gradient it moves the final density MLP's gradient by up to ~2e-1 in
# relative L2 when the ray origins move by one ulp on the CPU (the grid's
# positional derivative jumps at cell faces), so those leaves are checked
# finite only, and every other leaf against the limit.
TRAINER_ORIENTATION = ("Config.orientation_loss_mult = 0.01",
                       "Config.orientation_loss_target = 'normals_pred'")
# Phase 21's gradient limit, bracketed in every run as GRAD_REL_L2_TOL is.
TRAINER_MATERIAL_GRAD_REL_L2_TOL = 5e-2
# The material stage's loss terms (beside the cache's and the orientation's).
_TRAINER_MATERIAL_TERMS = ("data", "cache_data", "light_sampling", "material_ray_sampler",
                           "material_smoothness", "direct_indirect_consistency")


def _trainer_setup(torch, device, config_file, bindings=(), nudge=0):
    """The port's Trainer on a stage of `config_file` (in `bindings`), set up
    without data loading's thread: bindings synthesized, datasets and model on
    `device` (the model initialised on the CPU from the Config's seed, then
    moved). nudge=+-1 moves the cameras' positions by one ulp up or down
    before the train step takes them (the ray origins of a config that casts
    its rays in the step)."""
    import numpy as np

    from neural_radiance_caching_tpu_torch.engine import configs, gin_config
    from neural_radiance_caching_tpu_torch.engine.trainer import Trainer

    gin_config.clear_config()
    configs.load_config(config_files=[config_file],
                        bindings=list(TRAINER_BINDINGS) + list(bindings))
    trainer = Trainer(device=device)
    trainer._setup_names()
    trainer._setup_config_parameters()
    trainer._setup_binding_configs()
    trainer._setup_rng()
    trainer._load_datasets()
    if nudge:
        position = trainer.dataset.camtoworlds[..., :3, 3]
        position[...] = np.nextafter(position, np.float32(nudge * np.inf))
    trainer._setup_model()
    return trainer


def _trainer_step(torch, device, seed, nudge=0, fault=None, stage=TRAINER_CACHE_STAGE,
                  config_file=TRAINER_REF_CONFIG, checked=None, fault_kind="leveled",
                  planes_min=None):
    """One train step of a stage of `config_file` (synthetic_spheres.gin by
    default) through the Trainer's train step on `device`: the Trainer's
    first batch and weights, the draws from a CPU generator (the same numbers
    on both devices). nudge=+-1 moves the ray origins by one ulp up or down;
    `fault` is planted in the `fault_kind` kernel; with `checked`, a list,
    every leveled and planes call is held against its plain version
    (`_checking_scatter`) and recorded there; `planes_min` lowers the
    points from which a grid's backward takes the planes kernel."""
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda
    from neural_radiance_caching_tpu_torch.utils import pytrees

    trainer = _trainer_setup(torch, device, config_file, stage, nudge=nudge)
    batch = trainer.dataset.next_train()
    if nudge and not isinstance(batch.rays, pytrees.Pixels):
        o = batch.rays.origins
        batch = batch.replace(rays=batch.rays.replace(
            origins=torch.nextafter(o, torch.full_like(o, nudge * float("inf")))))
    before = dict(scatter_cuda.launches)
    patch = ({f"scatter_add_weighted_{fault_kind}": _planted_fault(fault, fault_kind)}
             if fault else {})
    if checked is not None:
        patch = {f"scatter_add_weighted_{k}": _checking_scatter(k, checked)
                 for k in ("leveled", "planes")}
    planes = {} if planes_min is None else dict(PLANES_MIN_POINTS=planes_min)
    with _patched(scatter_cuda, **patch), _patched(hashgrid, **planes):
        rng = torch.Generator().manual_seed(seed + 7)
        _, stats = trainer.train_step(rng, trainer.state, batch, 0.0)
    losses = {k: float(torch.as_tensor(v).detach()) for k, v in stats["losses"].items()}
    grads = {k: p.grad.detach().cpu() for k, p in trainer.model.named_parameters()}
    return losses, grads, {k: scatter_cuda.launches[k] - before[k] for k in before}


def phase_trainer_reference(torch, device, seed):
    """The Trainer's cache-stage step on synthetic_spheres.gin, GPU against
    CPU: every loss term and every gradient leaf."""
    l_cpu, g_cpu, n_cpu = _trainer_step(torch, "cpu", seed)
    floor, floor_at = _worst_grad_err(_trainer_step(torch, "cpu", seed, nudge=1)[1], g_cpu)
    l_gpu, g_gpu, n_gpu = _trainer_step(torch, device, seed)
    loss_errs = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    loss_err = max(loss_errs.values())
    err, err_at = _worst_grad_err(g_gpu, g_cpu)
    faults = {f: _worst_grad_err(_trainer_step(torch, device, seed, fault=f)[1], g_cpu)
              for f in ("taps rotated", "finest level dropped")}
    finite = all(torch.isfinite(g).all() for g in g_gpu.values())
    duplicated = {k for k in l_cpu if k.startswith("cache_")} == {
        "cache_" + k for k in l_cpu if not k.startswith("cache_")}
    tol = GRAD_REL_L2_TOL
    ok = (finite and duplicated and "mask" in l_cpu and loss_err <= 1e-4
          and n_cpu == _launch_counts() and n_gpu == _launch_counts(leveled=1)
          and floor <= tol and err <= tol and all(v > tol for v, _ in faults.values()))
    print(f"trainer reference: Trainer, {TRAINER_REF_CONFIG} cache stage, one step, the same "
          f"weights, batch and draws, gpu vs cpu: loss terms {sorted(l_cpu)} rel_err max="
          f"{loss_err:.3e} (tol 1e-4) grad rel_l2_err max={err:.3e} at {err_at} (tol {tol}; "
          f"noise floor, cpu vs cpu with origins +1 ulp: {floor:.3e} at {floor_at}; planted in "
          "the leveled kernel " + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in
                                             faults.items())
          + f", each must exceed the tol) kernel launches gpu={n_gpu} cpu={n_cpu} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the Trainer's GPU step disagrees with its CPU step")
    return dict(loss_rel_err=loss_err, grad_rel_l2_err=err, noise_floor=floor,
                faults={f: v for f, (v, _) in faults.items()}, tol=tol, launches=n_gpu["leveled"])


def _entry_point_run(torch, args, resume_args, ckpt, warmup, steps, patches=(), evaluate=True):
    """train_with_trainer.main(args) in-process with a host clock (ending in
    a sync) around the steps after `warmup`, the launch counts and the peak
    memory of that run (with `patches`, (object, {attribute: value}) pairs,
    set for its length); then, unless `resume_args` is None,
    train_with_trainer.main(resume_args), which must resume the checkpoint
    the first run wrote and take no step; then, unless `evaluate` is
    False, one test view through log_test_set_evaluation."""
    import os

    from neural_radiance_caching_tpu_torch import train_with_trainer
    from neural_radiance_caching_tpu_torch.engine import gin_config, trainer as trainer_lib
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.utils import checkpoints

    total = warmup + steps
    timing = {}
    setup_model = trainer_lib.Trainer._setup_model

    def timed_setup_model(self):
        """The Trainer's model set-up, then its train step wrapped in the host
        clock. Patched onto the Trainer class itself: a subclass would not
        take the gin bindings of `Trainer`."""
        setup_model(self)
        step_fn, calls = self.train_step, [0]

        def timed(*step_args):
            if calls[0] == warmup:
                torch.cuda.synchronize()
                timing["t0"] = time.perf_counter()
            out = step_fn(*step_args)
            calls[0] += 1
            if calls[0] == total:
                torch.cuda.synchronize()
                timing["t1"] = time.perf_counter()
            return out

        self.train_step = timed

    gin_config.clear_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    scatter_cuda.reset_launch_count()
    t_setup = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(trainer_lib.Trainer, _setup_model=timed_setup_model))
        for obj, attrs in patches:
            stack.enter_context(_patched(obj, **attrs))
        trainer = train_with_trainer.main(args)
    wall = time.perf_counter() - t_setup
    launches = dict(scatter_cuda.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    dt = (timing["t1"] - timing["t0"]) / steps
    log = [json.loads(line) for line in open(os.path.join(ckpt, "train_log.jsonl"))]
    losses = {k: v for k, v in log[-1].items() if k.startswith("loss")}
    saved = checkpoints.latest_checkpoint_step(ckpt)
    gin_config.clear_config()
    resume_ok = None
    if resume_args is not None:
        resumed = train_with_trainer.main(resume_args)
        log_after = open(os.path.join(ckpt, "train_log.jsonl")).read().splitlines()
        resume_ok = resumed.state.step == total and len(log_after) == len(log)
        del resumed
    metrics = eval_s = None
    if evaluate:
        t0 = time.perf_counter()
        metrics = trainer.log_test_set_evaluation(total, 1.0)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    return dict(trainer=trainer, step_s=dt, wall=wall, launches=launches, peak_gib=peak_gib,
                log=log, losses=losses, saved=saved, resume_ok=resume_ok, metrics=metrics,
                eval_s=eval_s, total=total,
                view=f"{trainer.test_dataset.height}x{trainer.test_dataset.width}")


def _finite(values):
    return all(v == v and abs(v) != float("inf") for v in values)


def _lpips_ok(metrics):
    """An evaluation scored LPIPS (on the card, the trainer's device) beside
    PSNR and SSIM, as the JAX harness does: lpips and avg_err finite, and
    whether its weights were calibrated."""
    return (all(k in metrics and math.isfinite(metrics[k]) for k in ("lpips", "avg_err"))
            and metrics.get("lpips_calibrated") in (0.0, 1.0))


def _lpips_text(metrics):
    return (f"lpips={metrics.get('lpips', float('nan')):.4f} lpips_calibrated="
            f"{metrics.get('lpips_calibrated', float('nan')):.1f} avg_err="
            f"{metrics.get('avg_err', float('nan')):.4f}")


def phase_trainer_train(torch, device, seed, steps, smi, tmp):
    """The full-width ngp_yobo.gin cache stage through the train_with_trainer
    entry point, in-process, into `tmp`: 3 warmup + N timed steps, a second
    run that resumes and takes no step, and one eval view. Returns its
    numbers and the checkpoint (phase 22 warm-starts from it)."""
    import os

    warmup = 3
    ckpt = os.path.join(tmp, "ngp_yobo_cache")
    args = [f"--gin_configs={TRAINER_CONFIG}"] + [
        f"--gin_bindings={b}" for b in TRAINER_BINDINGS + TRAINER_CACHE_STAGE + (
            f"Config.checkpoint_dir = '{ckpt}'", f"Config.early_exit_steps = {warmup + steps}",
            f"Config.print_every = {warmup + steps}", f"Config.jax_rng_seed = {20200823 + seed}")]
    run = _entry_point_run(torch, args, args, ckpt, warmup, steps)
    trainer, dt, losses, log, total = (run["trainer"], run["step_s"], run["losses"], run["log"],
                                       run["total"])
    finite = _finite(losses.values())
    duplicated = {k for k in losses if k.startswith("loss/cache_")} == {
        "loss/cache_" + k[5:] for k in losses if k.startswith("loss/") and
        not k.startswith("loss/cache_")}
    n_params = sum(p.numel() for p in trainer.model.parameters())
    metrics = run["metrics"]
    ok = (finite and duplicated and "loss/mask" in losses and run["saved"] == total
          and run["resume_ok"] and run["launches"] == _launch_counts()
          and math.isfinite(metrics["psnr"])
          and _lpips_ok(metrics))
    print(f"trainer train: train_with_trainer {TRAINER_CONFIG} cache stage ({n_params} params) "
          f"batch {trainer.batch_size} on SyntheticSpheres, {warmup} warmup + {steps} timed steps: "
          f"step_ms={dt * 1e3:.2f} rays_per_s={trainer.batch_size / dt:.0f} (train_log "
          f"rays_per_sec={log[-1]['rays_per_sec']:.0f} over steps 2-{total}) on [{smi}]; "
          f"peak {run['peak_gib']:.2f} GiB; losses finite={finite} {losses}; checkpoint step "
          f"{run['saved']}, resumed with no step={run['resume_ok']}; kernel launches="
          f"{run['launches']} (expected none: the density normals take the plain encoder); eval "
          f"view {run['view']}: psnr={metrics['psnr']:.2f} {_lpips_text(metrics)} "
          f"ssim={metrics['ssim']:.4f} in "
          f"{run['eval_s']:.2f}s; entry point {run['wall']:.1f}s {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("trainer train phase failed")
    return dict(step_ms=dt * 1e3, rays_per_s=trainer.batch_size / dt,
                train_log_rays_per_s=log[-1]["rays_per_sec"], peak_gib=run["peak_gib"],
                batch=trainer.batch_size, steps=steps, warmup=warmup, params=n_params,
                launches=run["launches"]["leveled"], eval_view=run["view"],
                eval_psnr=metrics["psnr"], eval_lpips=metrics["lpips"],
                eval_ssim=metrics["ssim"], eval_s=run["eval_s"],
                entry_point_s=run["wall"], losses=losses), ckpt


def phase_trainer_material_reference(torch, device, seed):
    """The Trainer's material stage step (material_light_from_scratch with
    resampling) on synthetic_spheres.gin, GPU against CPU: every loss term
    and every gradient leaf."""
    stage = TRAINER_MATERIAL_STAGE
    l_cpu, g_cpu, n_cpu = _trainer_step(torch, "cpu", seed, stage=stage)
    floor, floor_at = _worst_grad_err(
        _trainer_step(torch, "cpu", seed, nudge=1, stage=stage)[1], g_cpu)
    l_gpu, g_gpu, n_gpu = _trainer_step(torch, device, seed, stage=stage)
    loss_errs = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    loss_err = max(loss_errs.values())
    err, err_at = _worst_grad_err(g_gpu, g_cpu)
    faults = {f: _worst_grad_err(_trainer_step(torch, device, seed, fault=f, stage=stage)[1],
                                 g_cpu)
              for f in ("taps rotated", "finest level dropped")}
    finite = all(torch.isfinite(g).all() for g in g_gpu.values())
    terms = set(_TRAINER_MATERIAL_TERMS)
    present = terms <= set(l_cpu) and all(l_cpu[k] != 0 for k in terms)
    tol = TRAINER_MATERIAL_GRAD_REL_L2_TOL
    launches = _launch_counts(leveled=_TRAINER_MATERIAL_LAUNCHES_PER_STEP)
    ok = (finite and present and loss_err <= 1e-3 and n_cpu == _launch_counts()
          and n_gpu == launches and floor <= tol and err <= tol
          and all(v > tol for v, _ in faults.values()))
    print(f"trainer material reference: Trainer, {TRAINER_REF_CONFIG} material stage "
          f"(material_light_from_scratch, resample), one step, the same weights, batch and draws, "
          f"gpu vs cpu: loss rel_err max={loss_err:.3e} (tol 1e-3; "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(loss_errs.items()))
          + f") grad rel_l2_err max={err:.3e} at {err_at} (tol {tol}; noise floor, cpu vs cpu "
          f"with origins +1 ulp: {floor:.3e} at {floor_at}; planted in the leveled kernel "
          + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
          + f", each must exceed the tol) kernel launches gpu={n_gpu} cpu={n_cpu} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the Trainer's GPU material step disagrees with its CPU step")
    return dict(loss_rel_err=loss_err, loss_rel_errs=loss_errs, grad_rel_l2_err=err,
                noise_floor=floor, faults={f: v for f, (v, _) in faults.items()}, tol=tol,
                launches=n_gpu["leveled"], losses=l_gpu,
                orientation=_trainer_orientation_reference(torch, device, seed, tol, launches))


def _trainer_orientation_reference(torch, device, seed, tol, launches):
    """Phase 21's step with the hotdog's orientation loss, GPU against CPU:
    every loss term; the gradient leaves whose CPU noise floor (origins one
    ulp up, then down) is under a tenth of the limit, against the limit and
    two planted leveled faults; the others finite."""
    stage = TRAINER_MATERIAL_STAGE + TRAINER_ORIENTATION
    l_cpu, g_cpu, _ = _trainer_step(torch, "cpu", seed, stage=stage)
    floors = {}
    for nudge in (1, -1):
        for k, v in _grad_errs(_trainer_step(torch, "cpu", seed, nudge=nudge, stage=stage)[1],
                               g_cpu).items():
            floors[k] = max(floors.get(k, 0.0), v)
    held = {k for k, v in floors.items() if v <= tol / 10}
    l_gpu, g_gpu, n_gpu = _trainer_step(torch, device, seed, stage=stage)
    loss_errs = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    loss_err = max(loss_errs.values())

    def worst(g):
        errs = _grad_errs(g, g_cpu)
        at = max(held, key=errs.get)
        return errs[at], at, errs

    err, err_at, errs = worst(g_gpu)
    faults = {f: worst(_trainer_step(torch, device, seed, fault=f, stage=stage)[1])[:2]
              for f in ("taps rotated", "finest level dropped")}
    chaotic = {k: (errs[k], floors[k]) for k in sorted(set(floors) - held)}
    finite = all(torch.isfinite(g).all() for g in g_gpu.values())
    ok = (finite and l_cpu.get("cache_orientation", 0) > 0 and loss_err <= 1e-3
          and n_gpu == launches and held and err <= tol
          and all(v > tol for v, _ in faults.values()))
    print(f"trainer material reference with the orientation loss ({', '.join(TRAINER_ORIENTATION)}"
          f"): loss rel_err max={loss_err:.3e} (tol 1e-3; cache_orientation "
          f"{loss_errs['cache_orientation']:.2e}, material_ray_sampler "
          f"{loss_errs['material_ray_sampler']:.2e}) grad rel_l2_err max={err:.3e} at {err_at} "
          f"over the {len(held)} of {len(floors)} leaves whose noise floor (cpu vs cpu, origins "
          f"+-1 ulp) is under {tol / 10:g} (tol {tol}; planted in the leveled kernel "
          + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
          + ", each must exceed the tol); finite, with (gpu err, noise floor): "
          + ", ".join(f"{k} ({e:.2e}, {f:.2e})" for k, (e, f) in chaotic.items())
          + f"; finite={finite} kernel launches gpu={n_gpu} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the Trainer's GPU material step with the orientation loss "
                             "disagrees with its CPU step")
    return dict(loss_rel_err=loss_err, grad_rel_l2_err=err, held=len(held), leaves=len(floors),
                faults={f: v for f, (v, _) in faults.items()},
                finite_only={k: dict(err=e, noise_floor=f) for k, (e, f) in chaotic.items()})


# The README's second stage as train_one_stage.py builds it for
# `-c ngp_yobo -t material_light_from_scratch_resample --sample_factor 8
# --batch_size 1024 --render_chunk_size 1024`.
TRAINER_MATERIAL_COMMAND = ("-c", "ngp_yobo", "-t", "material_light_from_scratch_resample",
                            "--sample_factor", "8", "--batch_size", "1024",
                            "--render_chunk_size", "1024")
def phase_trainer_material_train(torch, device, seed, steps, smi, tmp, cache_ckpt,
                                 profile=None):
    """The README's second stage on the full-width ngp_yobo.gin through the
    train_with_trainer entry point, in-process, warm-started from phase 20's
    cache checkpoint: 3 warmup + N timed steps, a second run that resumes its
    own checkpoint and takes no step, and one 48^2 eval view at chunk 1024."""
    import os

    from neural_radiance_caching_tpu_torch import train_one_stage

    warmup = 3
    ckpt = os.path.join(tmp, "ngp_yobo_material_light_from_scratch")
    command = train_one_stage.stage_command(
        list(TRAINER_MATERIAL_COMMAND) + ["--device", device], checkpoint_dir=ckpt,
        partial_checkpoint_dir=cache_ckpt)
    command = [c for c in command[3:] if c != "--logtostderr"]  # the entry point's arguments
    extra = [f"--gin_bindings={b}" for b in TRAINER_BINDINGS + (
        f"Config.early_exit_steps = {warmup + steps}", f"Config.print_every = {warmup + steps}",
        f"Config.jax_rng_seed = {20200823 + seed}")]
    resume = [c for c in command if "partial_checkpoint_dir" not in c]
    run = _entry_point_run(torch, command + extra, resume + extra, ckpt, warmup, steps)
    trainer, dt, losses, log, total = (run["trainer"], run["step_s"], run["losses"], run["log"],
                                       run["total"])
    terms = [f"loss/{k}" for k in _TRAINER_MATERIAL_TERMS]
    finite = _finite(losses.values()) and all(k in losses for k in terms)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    metrics = run["metrics"]
    cfg = trainer.config
    ok = (finite and run["saved"] == total and run["resume_ok"]
          and run["launches"] == _launch_counts() and math.isfinite(metrics["psnr"])
          and _lpips_ok(metrics))
    print(f"trainer material train: train_with_trainer {TRAINER_CONFIG} "
          f"{' '.join(TRAINER_MATERIAL_COMMAND[2:])} warm-started from the cache stage "
          f"({n_params} params, {trainer.model.shader.num_secondary_samples} secondary rays per "
          f"point, gradient_checkpointing={cfg.gradient_checkpointing}) batch "
          f"{trainer.batch_size}, {warmup} warmup + {steps} timed steps: step_ms={dt * 1e3:.2f} "
          f"rays_per_s={trainer.batch_size / dt:.0f} "
          f"(train_log rays_per_sec={log[-1]['rays_per_sec']:.0f} over steps 2-{total}) on "
          f"[{smi}]; peak {run['peak_gib']:.2f} GiB; losses finite and present={finite} {losses}; "
          f"checkpoint step {run['saved']}, resumed with no step={run['resume_ok']}; kernel "
          f"launches={run['launches']} (expected none); eval view {run['view']} at chunk "
          f"{cfg.render_chunk_size}: psnr={metrics['psnr']:.2f} {_lpips_text(metrics)} "
          f"ssim={metrics['ssim']:.4f} in "
          f"{run['eval_s']:.2f}s; entry point {run['wall']:.1f}s {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("trainer material train phase failed")
    if profile:
        path = str(profile)
        stem, dot, ext = path.rpartition(".")
        batches = [trainer.dataset.next_train() for _ in range(2)]
        _profile(torch, trainer.train_step, trainer.state, trainer.rng, batches,
                 f"{stem}.trainer_material.{ext}" if dot else path + ".trainer_material",
                 steps=2)
    return dict(step_ms=dt * 1e3, rays_per_s=trainer.batch_size / dt,
                train_log_rays_per_s=log[-1]["rays_per_sec"], peak_gib=run["peak_gib"],
                batch=trainer.batch_size, steps=steps, warmup=warmup, params=n_params,
                launches=run["launches"]["leveled"],
                eval_view=run["view"], eval_psnr=metrics["psnr"], eval_lpips=metrics["lpips"],
                eval_ssim=metrics["ssim"],
                eval_s=run["eval_s"], entry_point_s=run["wall"], losses=losses)


# InvProp's cache stage, configs/transient_simulation_ngp_yobo_cornell.gin,
# cache stage: Pixels batches cast in the train step, three grid proposal
# levels with density normals (the plain encoder, second order: no kernel),
# the cache shader's own appearance grid (the leveled kernel once per step;
# at full width batch x 32 samples, 8 levels, F = 4, 2^19 rows),
# 700 bins, the density-grid regularizer and geometry smoothness. The
# finetune stages' occlusion bindings add shadow rays: one per sample,
# traced through the cache's weights only, graph-free, no kernel.
TRANSIENT_CONFIG = "configs/transient_simulation_ngp_yobo_cornell.gin"
TRANSIENT_OCCLUSIONS = ("Config.use_occlusions = True", "Config.occlusions_secondary_only = False",
                        "Config.occlusions_primary_only = False")
_TRANSIENT_GRID = "'hash_map_size': 4096, 'max_grid_size': 128"
# Phase 23's widths: 4-level grids of 4096 rows, 16-wide MLPs, 16 samples per
# level, 64 bins of 0.25 (the scene's path lengths reach ~9), batch 64;
# the occlusion threshold at 0, so that every shadow ray's opacity reaches
# the direct light (the reference widths' shadow opacities stay under
# cornell's 0.9).
TRANSIENT_NARROW = (
    "Config.batch_size = 64", "Config.num_dataset_images = 4", "Config.n_bins = 64",
    "Config.exposure_time = 0.25", "Config.occ_threshold_min = 0.0",
    "Config.occ_threshold_max = 0.0",
    "ProposalVolumeSampler.sampling_strategy = ((0, 0, 16), (1, 1, 16), (2, 2, 16))",
    "TransientNeRFModel.train_sampling_strategy = ((0, 0, 16), (1, 1, 16), (2, 2, 16))",
    "TransientNeRFModel.render_sampling_strategy = ((0, 0, 16), (1, 1, 16), (2, 2, 16))",
    "ProposalVolumeSampler.mlp_params_per_level = ("
    "{'disable_density_normals': False, 'enable_pred_normals': False, "
    "'normals_for_filter_only': True, 'net_depth': 2, 'net_width': 16}, "
    "{'disable_density_normals': False, 'enable_pred_normals': False, "
    "'normals_for_filter_only': True, 'net_depth': 2, 'net_width': 16}, "
    "{'disable_density_normals': False, 'enable_pred_normals': True, "
    "'normals_for_filter_only': False, 'net_depth': 2, 'net_width': 16})",
    f"ProposalVolumeSampler.grid_params_per_level = ({{{_TRANSIENT_GRID}, 'num_features': 1}}, "
    f"{{{_TRANSIENT_GRID}, 'num_features': 1}}, {{{_TRANSIENT_GRID}, 'num_features': 4}})",
    "HashEncoding.hash_map_size = 4096", "HashEncoding.max_grid_size = 128",
    f"TransientNeRFMLP.grid_params = {{{_TRANSIENT_GRID}, 'num_features': 4}}",
    "TransientNeRFMLP.net_width = 16", "TransientNeRFMLP.bottleneck_width = 16",
    "TransientNeRFMLP.net_width_integrated_brdf = 8", "TransientNeRFMLP.net_width_brdf = 8",
    "TransientNeRFMLP.net_width_irradiance = 8", "TransientNeRFMLP.bottleneck_irradiance = 8",
    "TransientSurfaceLightFieldMLP.net_width_viewdirs = 16",
    "TransientSurfaceLightFieldMLP.bottleneck_viewdirs = 16")
# The transient stage's loss terms (beside the cache's geometry terms).
_TRAINER_TRANSIENT_TERMS = ("data", "cache_data", "mask", "geometry_smoothness",
                            "regularizer_density_grid")
# Phase 24's batch: scripts/train_one_stage.py's default, which the port's
# train_one_stage.py passes; halved while a run does not fit.
TRANSIENT_BATCHES = (8192, 4096, 2048, 1024)


def _gpu_vs_cpu_step(torch, device, seed, stage, config_file, launches, terms,
                     tol=GRAD_REL_L2_TOL, fault_kind="leveled", planes_min=None):
    """One Trainer step of `stage` on `config_file`, GPU against CPU on the
    same weights, batch and draws: every loss term (each of `terms` present
    and nonzero), every gradient leaf (the limit `tol` bracketed by the
    CPU's noise floor with the cameras +-1 ulp and two faults planted in the
    `fault_kind` kernel), every GPU scatter call held against its plain
    version; `launches`, {kind: count}, the calls expected (`planes_min` as
    `_trainer_step`'s). The readings, with `ok` and the launches by kind."""
    counts = launches

    def step(dev, **kw):
        return _trainer_step(torch, dev, seed, stage=stage, config_file=config_file,
                             fault_kind=fault_kind, planes_min=planes_min, **kw)

    l_cpu, g_cpu, n_cpu = step("cpu")
    floor, floor_at, loss_floor = 0.0, None, 0.0
    for nudge in (1, -1):
        l_n, g_n, _ = step("cpu", nudge=nudge)
        v, at = _worst_grad_err(g_n, g_cpu)
        if v >= floor:
            floor, floor_at = v, at
        loss_floor = max(loss_floor, *(abs(l_n[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-30)
                                       for k in l_cpu))
    checked = []
    l_gpu, g_gpu, n_gpu = step(device, checked=checked)
    loss_errs = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-30) for k in l_cpu}
    err, err_at = _worst_grad_err(g_gpu, g_cpu)
    faults = {f: _worst_grad_err(step(device, fault=f)[1], g_cpu)
              for f in ("taps rotated", "finest level dropped") if sum(counts.values())}
    ok = (all(torch.isfinite(g).all() for g in g_gpu.values())
          and set(terms) <= set(l_cpu) and all(l_cpu[k] != 0 for k in terms)
          and max(loss_errs.values()) <= 1e-3 and n_cpu == _launch_counts()
          and n_gpu == _launch_counts(**counts) and len(checked) == sum(counts.values())
          and all(c["ok"] for c in checked) and floor <= tol and err <= tol
          and all(v > tol for v, _ in faults.values()))
    return dict(ok=ok, loss_rel_err=max(loss_errs.values()), loss_rel_errs=loss_errs,
                loss_noise_floor=loss_floor, grad_rel_l2_err=err, grad_err_at=err_at,
                grad_rel_l2_errs=_grad_errs(g_gpu, g_cpu), noise_floor=floor,
                noise_floor_at=floor_at, faults={f: v for f, (v, _) in faults.items()},
                fault_at={f: at for f, (_, at) in faults.items()}, tol=tol,
                launches={k: n_gpu[k] for k in counts}, cpu_launches=n_cpu,
                checked=checked, fault_kind=fault_kind,
                max_abs_err=max((c["max_abs_err"] for c in checked), default=0.0), losses=l_gpu)


def _gpu_vs_cpu_text(r):
    """The readings of `_gpu_vs_cpu_step` as the reference phases print them."""
    return (f"loss rel_err max={r['loss_rel_err']:.3e} (tol 1e-3; "
            + ", ".join(f"{k} {v:.2e}" for k, v in sorted(r["loss_rel_errs"].items()))
            + f"; cpu vs cpu with the cameras +-1 ulp: {r['loss_noise_floor']:.2e}) grad "
            f"rel_l2_err max={r['grad_rel_l2_err']:.3e} at {r['grad_err_at']} (tol {r['tol']}; "
            f"noise floor, cpu vs cpu with the cameras +-1 ulp: {r['noise_floor']:.3e} at "
            f"{r['noise_floor_at']}; "
            + (f"planted in the {r.get('fault_kind', 'leveled')} kernel " + ", ".join(
                f"{f}: {v:.3e} at {r['fault_at'][f]}" for f, v in r["faults"].items())
               + ", each must exceed the tol)" if r["faults"] else
               "no fault planted: the step launches no kernel)"))


def _checked_text(checked):
    return "; ".join(f"idx{list(c['shape'])} max_abs_err={c['max_abs_err']:.3e} "
                     f"{'ok' if c['ok'] else 'FAIL'}" for c in checked)


def phase_trainer_transient_reference(torch, device, seed):
    """The Trainer's step on a narrow cornell cache stage with the occlusion
    bindings, GPU against CPU (`_gpu_vs_cpu_step`); the losses also carry
    their `cache_` duplicates."""
    r = _gpu_vs_cpu_step(torch, device, seed,
                         TRAINER_CACHE_STAGE + TRANSIENT_NARROW + TRANSIENT_OCCLUSIONS,
                         TRANSIENT_CONFIG, launches={"leveled": 1},
                         terms=_TRAINER_TRANSIENT_TERMS)
    losses = r["losses"]
    duplicated = {k for k in losses if k.startswith("cache_")} == {
        "cache_" + k for k in losses
        if not k.startswith(("cache_", "regularizer_")) and k != "geometry_smoothness"}
    ok = r["ok"] and duplicated
    print(f"trainer transient reference: Trainer, {TRANSIENT_CONFIG} cache stage at reference "
          f"widths with the occlusion bindings (shadow rays), one step, the same weights, batch "
          f"and draws, gpu vs cpu: {_gpu_vs_cpu_text(r)}; the leveled call against its plain "
          f"version: {_checked_text(r['checked'])}; kernel launches gpu={r['launches']} "
          f"cpu={r['cpu_launches']} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the Trainer's GPU transient step disagrees with its CPU step")
    return {k: r[k] for k in ("loss_rel_err", "loss_rel_errs", "loss_noise_floor",
                              "grad_rel_l2_err", "noise_floor", "faults", "tol", "launches",
                              "max_abs_err", "losses")}


def _transient_checked_step(torch, device, seed, batch, capture):
    """One full-width cornell cache step with the occlusion bindings (shadow
    rays) through the Trainer's train step, every leveled call held against
    its plain version and the first one's inputs kept in `capture`; then one
    more step, timed by host clock ending in a sync, with its peak memory."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    trainer = _trainer_setup(torch, device, TRANSIENT_CONFIG, TRAINER_CACHE_STAGE + (
        f"Config.batch_size = {batch}", f"Config.jax_rng_seed = {20200823 + seed}")
        + TRANSIENT_OCCLUSIONS)
    calls = []
    scatter_cuda.reset_launch_count()
    with _patched(scatter_cuda,
                  scatter_add_weighted_leveled=_checking_scatter("leveled", calls, capture)):
        trainer.state, stats = trainer.train_step(trainer.rng, trainer.state,
                                                  trainer.dataset.next_train(), 0.5)
    losses = {k: float(torch.as_tensor(v).detach()) for k, v in stats["losses"].items()}
    launches = dict(scatter_cuda.launches)
    batch_data = trainer.dataset.next_train()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.state, stats = trainer.train_step(trainer.rng, trainer.state, batch_data, 0.5)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    sizes = [int(v) for v in trainer.model.cache.shader.grid.grid_sizes]
    finite = _finite(losses.values()) and bool(torch.isfinite(stats["loss"]))
    del trainer
    return dict(calls=calls, launches=launches, step_ms=step_ms, peak_gib=peak, losses=losses,
                finite=finite, sizes=sizes)


def phase_trainer_transient_train(torch, device, seed, steps, smi, tmp):
    """The full-width cornell cache stage through the train_with_trainer entry
    point, in-process, into `tmp`, at the largest batch of TRANSIENT_BATCHES
    that fits: 3 warmup + N timed steps, a second run that resumes and takes
    no step, one test view cast on the host; then one checked step with the
    occlusion bindings (shadow rays at full width), whose leveled inputs time
    the kernel on this path's own updates."""
    import gc
    import os

    from neural_radiance_caching_tpu_torch.engine import gin_config

    warmup, cut = 3, []
    for batch in TRANSIENT_BATCHES:
        ckpt = os.path.join(tmp, f"cornell_cache_{batch}")
        args = [f"--gin_configs={TRANSIENT_CONFIG}"] + [
            f"--gin_bindings={b}" for b in TRAINER_BINDINGS + TRAINER_CACHE_STAGE + (
                f"Config.batch_size = {batch}", f"Config.checkpoint_dir = '{ckpt}'",
                f"Config.early_exit_steps = {warmup + steps}",
                f"Config.print_every = {warmup + steps}",
                f"Config.jax_rng_seed = {20200823 + seed}",
                # The transient h5 save of an eval view is not ported.
                "Trainer.save_results = False")]
        try:
            run = _entry_point_run(torch, args, args, ckpt, warmup, steps)
            break
        except torch.cuda.OutOfMemoryError as e:
            print(f"trainer transient train: batch {batch} ran out of memory: "
                  f"{str(e).splitlines()[0]}", flush=True)
            cut.append(batch)
            gin_config.clear_config()
            gc.collect()
            torch.cuda.empty_cache()
    else:
        raise AssertionError(f"no batch of {TRANSIENT_BATCHES} fits")
    trainer, dt, losses, log, total = (run["trainer"], run["step_s"], run["losses"], run["log"],
                                       run["total"])
    terms = [f"loss/{k}" for k in _TRAINER_TRANSIENT_TERMS]
    finite = _finite(losses.values()) and all(k in losses for k in terms)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    metrics = run["metrics"]
    n_bins = trainer.config.n_bins
    ok = (finite and run["saved"] == total and run["resume_ok"]
          and run["launches"] == _launch_counts(leveled=total)
          and math.isfinite(metrics["psnr"])
          and _lpips_ok(metrics))
    cut_text = (f"batch {batch}, cut from {TRANSIENT_BATCHES[0]} ({', '.join(map(str, cut))} "
                "ran out of memory)" if cut else f"batch {batch}")
    print(f"trainer transient train: train_with_trainer {TRANSIENT_CONFIG} cache stage "
          f"({n_params} params, {n_bins} bins, Pixels batches cast in the step) {cut_text} on "
          f"SyntheticSpheres, {warmup} warmup + {steps} timed steps: step_ms={dt * 1e3:.2f} "
          f"rays_per_s={batch / dt:.0f} (train_log rays_per_sec={log[-1]['rays_per_sec']:.0f} "
          f"over steps 2-{total}) on [{smi}]; peak {run['peak_gib']:.2f} GiB; losses finite and "
          f"present={finite} {losses}; checkpoint step {run['saved']}, resumed with no step="
          f"{run['resume_ok']}; kernel launches={run['launches']} (expected {total} leveled, one "
          f"per step: the appearance grid); eval view {run['view']} cast on the host: psnr="
          f"{metrics['psnr']:.2f} ssim={metrics['ssim']:.4f} {_lpips_text(metrics)} transient_iou="
          f"{metrics.get('transient_iou', float('nan')):.4f} in {run['eval_s']:.2f}s; entry point "
          f"{run['wall']:.1f}s {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("trainer transient train phase failed")
    result = dict(step_ms=dt * 1e3, rays_per_s=batch / dt,
                  train_log_rays_per_s=log[-1]["rays_per_sec"], peak_gib=run["peak_gib"],
                  batch=batch, batch_cut_from=TRANSIENT_BATCHES[0] if cut else None,
                  steps=steps, warmup=warmup, params=n_params, launches=total, n_bins=n_bins,
                  eval_view=run["view"], eval_psnr=metrics["psnr"], eval_lpips=metrics["lpips"],
                  eval_ssim=metrics["ssim"],
                  eval_transient_iou=metrics.get("transient_iou"), eval_s=run["eval_s"],
                  entry_point_s=run["wall"], losses=losses)
    del trainer, run
    gc.collect()
    torch.cuda.empty_cache()

    capture, occ_cut = {}, []
    for occ_batch in [b for b in TRANSIENT_BATCHES if b <= batch]:
        try:
            occ = _transient_checked_step(torch, device, seed, occ_batch, capture)
            break
        except torch.cuda.OutOfMemoryError:
            occ_cut.append(occ_batch)
            capture.clear()
            gc.collect()
            torch.cuda.empty_cache()
    else:
        raise AssertionError("no batch fits the step with shadow rays")
    calls = occ["calls"]
    occ_ok = (occ["finite"] and len(calls) == 1 and all(c["ok"] for c in calls)
              and occ["launches"] == _launch_counts(leveled=1))
    occ_cut_text = f" (cut: {', '.join(map(str, occ_cut))} ran out of memory)" if occ_cut else ""
    print(f"trainer transient train with the occlusion bindings (shadow rays, one per sample): "
          f"batch {occ_batch}{occ_cut_text}; checked step, the leveled call against its plain version on the same inputs, "
          f"tol=|err|<={SUM_ORDER_TOL}*sum|w*ct|: "
          + "; ".join(f"idx{list(c['shape'])} max_abs_err={c['max_abs_err']:.3e} "
                      f"{'ok' if c['ok'] else 'FAIL'}" for c in calls)
          + f"; the next step {occ['step_ms']:.2f} ms by host clock, peak {occ['peak_gib']:.2f} "
          f"GiB on [{smi}]; losses finite={occ['finite']}; kernel launches in the checked step="
          f"{occ['launches']} (expected 1 leveled; the shadow pass has no graph) "
          f"{'ok' if occ_ok else 'FAIL'}", flush=True)
    if not occ_ok:
        raise AssertionError("trainer transient step with shadow rays failed")
    path = phase_kernel_path("leveled", capture, occ["sizes"],
                             f"cornell cache stage's own updates (the appearance grid, batch "
                             f"{occ_batch})")
    capture.clear()
    result["occlusions"] = dict(batch=occ_batch, step_ms=occ["step_ms"], peak_gib=occ["peak_gib"],
                                launches=occ["launches"]["leveled"],
                                max_abs_err=max(c["max_abs_err"] for c in calls),
                                losses=occ["losses"])
    result["path"] = path
    return result, os.path.join(tmp, f"cornell_cache_{batch}")


# InvProp's material stages on cornell (material_light_from_scratch, and
# material_light_finetune with its shadow rays), warm-started from the cache
# stage: the cache shader lit by the material shader's power on its
# secondary queries (share_light_power), the secondary rays' near bound
# pushed off the surface (shadow_eps_indirect), the stage's extra losses.
# Under the occlusion bindings shadow rays leave every primary sample, every
# surface point and the point each secondary query resamples, graph-free.
# Phase 25's widths: phase 23's narrow cache, a narrow light sampler and
# material shader, one secondary ray of each lobe per surface point.
TRANSIENT_MATERIAL_NARROW = (
    "Trainer.stage = 'material_light_from_scratch'", "Trainer.resample = True",
    "Trainer.sample_factor = 1", "LightMLP.num_components = 8", "LightMLP.net_width = 16",
    "LightMLP.bottleneck_width = 16", "TransientMaterialMLP.net_width = 16",
    "TransientMaterialMLP.bottleneck_width = 16",
    f"TransientMaterialMLP.grid_params = {{{_TRANSIENT_GRID}, 'num_features': 4}}",
    "TransientMaterialMLP.cache_train_sampling_strategy = ((0, 0, 16), (1, 1, 16), (2, 2, 16))",
    "TransientMaterialMLP.cache_render_sampling_strategy = ((0, 0, 16), (1, 1, 16), (2, 2, 16))",
    "LightSourceMap.net_width = 16") + TRANSIENT_NARROW
# The leveled kernel per material step (narrow and full width): the cache
# shader's appearance grid on the primary samples, on the surface points
# (twice: the consistency targets and the consistency integrator) and on
# the secondary queries' resampled points, the material shader's grid and
# the light sampler's grid. The shadow rays add none (no graph).
_TRAINER_TRANSIENT_MATERIAL_LAUNCHES_PER_STEP = {"leveled": 6}
_TRAINER_TRANSIENT_MATERIAL_TERMS = ("data", "cache_data", "light_sampling",
                                     "material_ray_sampler", "material_smoothness",
                                     "direct_indirect_consistency")
# Phase 26: the README's recipe for the material stages (Trainer.resample,
# the `_resample` suffix of train_one_stage.py), the trainer's default of
# 2 x 4 secondary rays per surface point; its stages and timed steps.
TRANSIENT_MATERIAL_STAGES = ("material_light_from_scratch", "material_light_finetune")
TRANSIENT_MATERIAL_RECIPE = ("Trainer.resample = True", "Trainer.resample_render = True")


def phase_trainer_transient_material_reference(torch, device, seed):
    """The Trainer's step on a narrow cornell material_light_from_scratch
    stage, without and with the finetune stages' occlusion bindings, GPU
    against CPU (`_gpu_vs_cpu_step`, each with its own noise floor and
    planted faults; 6 leveled launches per step)."""
    out = {}
    for label, extra in (("direct", ()), ("occlusions", TRANSIENT_OCCLUSIONS)):
        r = _gpu_vs_cpu_step(torch, device, seed, TRANSIENT_MATERIAL_NARROW + extra,
                             TRANSIENT_CONFIG,
                             launches=_TRAINER_TRANSIENT_MATERIAL_LAUNCHES_PER_STEP,
                             terms=_TRAINER_TRANSIENT_MATERIAL_TERMS)
        print(f"trainer transient material reference ({label}): Trainer, {TRANSIENT_CONFIG} "
              f"material_light_from_scratch at reference widths"
              f"{' with the occlusion bindings (shadow rays)' if extra else ''}, one step, the "
              f"same weights, batch and draws, gpu vs cpu: {_gpu_vs_cpu_text(r)}; every leaf: "
              + ", ".join(f"{k} {v:.2e}" for k, v in sorted(r["grad_rel_l2_errs"].items()))
              + f"; the leveled calls against their plain version: {_checked_text(r['checked'])}"
              f"; kernel launches gpu={r['launches']} cpu={r['cpu_launches']} "
              f"{'ok' if r['ok'] else 'FAIL'}", flush=True)
        if not r["ok"]:
            raise AssertionError("the Trainer's GPU transient material step disagrees with its "
                                 "CPU step")
        out[label] = {k: r[k] for k in (
            "loss_rel_err", "loss_rel_errs", "loss_noise_floor", "grad_rel_l2_err",
            "grad_err_at", "grad_rel_l2_errs", "noise_floor", "faults", "tol", "launches",
            "max_abs_err")}
    return out


def _shadow_ray_counter():
    """(patch, count): TransientNeRFMLP._compute_occlusions counting the
    shadow rays it traces (one per filtered sample, where the occlusion
    bindings let it trace)."""
    from neural_radiance_caching_tpu_torch.models import nerf_shader

    original = nerf_shader.TransientNeRFMLP._compute_occlusions
    count = [0]

    def counting(self, rng, rays, light_dists, radiance_cache, train_frac, train, is_secondary,
                 filtered):
        cfg = self.config
        if cfg.use_occlusions and not (cfg.occlusions_secondary_only and not is_secondary) \
                and not (cfg.occlusions_primary_only and is_secondary):
            count[0] += filtered["means"][..., 0].numel()
        return original(self, rng, rays, light_dists, radiance_cache, train_frac, train,
                        is_secondary, filtered)

    return (nerf_shader.TransientNeRFMLP, {"_compute_occlusions": counting}), count


def phase_trainer_transient_material_train(torch, device, seed, steps, smi, tmp, cache_ckpt):
    """The full-width cornell material stages through the train_with_trainer
    entry point, in-process: material_light_from_scratch warm-started from
    phase 24's cache checkpoint (3 warmup + N timed steps), then
    material_light_finetune warm-started from its checkpoint (3 warmup + 3
    timed steps, with shadow rays); each at the largest batch of
    TRANSIENT_BATCHES that fits (a batch that runs out of memory is printed
    as a cut), a second run that resumes and takes no step, one eval view,
    then one step with every scatter held against its plain version, whose
    largest leveled call times the kernel on the stage's own updates."""
    import gc
    import os

    from neural_radiance_caching_tpu_torch.engine import gin_config
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    warmup, results, warm = 3, {}, cache_ckpt
    for stage in TRANSIENT_MATERIAL_STAGES:
        timed = steps if stage == TRANSIENT_MATERIAL_STAGES[0] else 3
        cut = []
        for batch in TRANSIENT_BATCHES:
            ckpt = os.path.join(tmp, f"cornell_{stage}_{batch}")
            common = TRAINER_BINDINGS + TRANSIENT_MATERIAL_RECIPE + (
                f"Trainer.stage = '{stage}'", f"Config.batch_size = {batch}",
                f"Config.checkpoint_dir = '{ckpt}'",
                f"Config.early_exit_steps = {warmup + timed}",
                f"Config.print_every = {warmup + timed}",
                f"Config.jax_rng_seed = {20200823 + seed}", "Trainer.save_results = False")
            resume = [f"--gin_configs={TRANSIENT_CONFIG}"] + [f"--gin_bindings={b}"
                                                              for b in common]
            args = resume + [f"--gin_bindings=Config.partial_checkpoint_dir = '{warm}'"]
            patch, shadow_rays = _shadow_ray_counter()
            try:
                run = _entry_point_run(torch, args, resume, ckpt, warmup, timed, (patch,))
                break
            except torch.cuda.OutOfMemoryError as e:
                allocated = torch.cuda.memory_allocated() / 2**30
                reserved = torch.cuda.memory_reserved() / 2**30
                print(f"trainer transient material train ({stage}): batch {batch} ran out of "
                      f"memory ({allocated:.2f} GiB allocated, {reserved:.2f} GiB reserved at "
                      f"the failing request): {str(e).splitlines()[0]}", flush=True)
                cut.append(dict(batch=batch, allocated_gib=allocated, reserved_gib=reserved))
                del e
                gin_config.clear_config()
                gc.collect()
                torch.cuda.empty_cache()
        else:
            raise AssertionError(f"no batch of {TRANSIENT_BATCHES} fits the {stage} stage")
        trainer, dt, losses, log, total = (run["trainer"], run["step_s"], run["losses"],
                                           run["log"], run["total"])
        terms = [f"loss/{k}" for k in _TRAINER_TRANSIENT_MATERIAL_TERMS]
        finite = _finite(losses.values()) and all(k in losses for k in terms)
        per_step = {k: v / total for k, v in run["launches"].items()}
        step_launches = _TRAINER_TRANSIENT_MATERIAL_LAUNCHES_PER_STEP
        expected = _launch_counts(**{k: v * total for k, v in step_launches.items()})
        shadow = shadow_rays[0] / total
        occlusions = trainer.config.use_occlusions
        metrics = run["metrics"]
        n_params = sum(p.numel() for p in trainer.model.parameters())
        n_sec = trainer.model.shader.num_secondary_samples

        # One more step, every scatter held against its plain version.
        calls, captures = [], {"leveled": {}, "planes": {}}
        scatter_cuda.reset_launch_count()
        with _patched(scatter_cuda, **{
                f"scatter_add_weighted_{k}": _checking_scatter(k, calls, captures[k], largest=True)
                for k in captures}):
            trainer.state, stats = trainer.train_step(trainer.rng, trainer.state,
                                                      trainer.dataset.next_train(), 0.5)
        checked_launches = dict(scatter_cuda.launches)
        ok = (finite and run["saved"] == total and run["resume_ok"]
              and run["launches"] == expected and math.isfinite(metrics["psnr"])
              and _lpips_ok(metrics)
              and occlusions == ("finetune" in stage) and (shadow > 0) == occlusions
              and bool(torch.isfinite(stats["loss"])) and all(c["ok"] for c in calls)
              and checked_launches == _launch_counts(**step_launches)
              and len(calls) == sum(step_launches.values()))
        cut_text = (f"batch {batch}, cut from {TRANSIENT_BATCHES[0]} ("
                    + ", ".join(f"{c['batch']} ran out of memory at {c['allocated_gib']:.2f} "
                                f"GiB allocated, {c['reserved_gib']:.2f} reserved" for c in cut)
                    + ")" if cut else f"batch {batch}")
        print(f"trainer transient material train: train_with_trainer {TRANSIENT_CONFIG} "
              f"{stage} warm-started from {os.path.basename(warm)} ({n_params} params, "
              f"{trainer.config.n_bins} bins, {n_sec} secondary rays per surface point, "
              f"occlusions={occlusions}) {cut_text}, {warmup} warmup + "
              f"{timed} timed steps: step_ms={dt * 1e3:.2f} rays_per_s={batch / dt:.0f} "
              f"(train_log rays_per_sec={log[-1]['rays_per_sec']:.0f} over steps 2-{total}) on "
              f"[{smi}]; peak {run['peak_gib']:.2f} GiB; shadow rays per step {shadow:.0f}; "
              f"losses finite and present={finite} {losses}; checkpoint step {run['saved']}, "
              f"resumed with no step={run['resume_ok']}; kernel launches={run['launches']} "
              f"(per step {per_step}, expected {step_launches}); eval "
              f"view {run['view']} cast on the host: psnr={metrics['psnr']:.2f} "
              f"{_lpips_text(metrics)} in "
              f"{run['eval_s']:.2f}s; checked step, every scatter against its plain version "
              f"(tol=|err|<={SUM_ORDER_TOL}*sum|w*ct|): "
              + "; ".join(f"{c['kind']} idx{list(c['shape'])} max_abs_err={c['max_abs_err']:.3e} "
                          f"{'ok' if c['ok'] else 'FAIL'}" for c in calls)
              + f"; entry point {run['wall']:.1f}s {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"trainer transient material train phase failed ({stage})")
        paths = {}
        for kind, capture in captures.items():
            if capture:
                levels = capture["idx"].shape[0]
                paths[kind] = phase_kernel_path(
                    kind, capture, [f"level {i}" for i in range(levels)],
                    f"cornell {stage}'s own updates (its largest {kind} call, batch {batch})")
                paths[kind]["path_shape"] = list(capture["idx"].shape)
        captures.clear()
        results[stage] = dict(
            step_ms=dt * 1e3, rays_per_s=batch / dt, train_log_rays_per_s=log[-1]["rays_per_sec"],
            peak_gib=run["peak_gib"], batch=batch, cut=cut, steps=timed, warmup=warmup,
            params=n_params, secondary_rays_per_point=n_sec, shadow_rays_per_step=shadow,
            launches=run["launches"], launches_per_step=per_step, eval_view=run["view"],
            eval_psnr=metrics["psnr"], eval_lpips=metrics["lpips"],
            eval_s=run["eval_s"], entry_point_s=run["wall"],
            losses=losses, max_abs_err=max(c["max_abs_err"] for c in calls), paths=paths)
        warm = ckpt
        del trainer, run, stats
        gin_config.clear_config()
        gc.collect()
        torch.cuda.empty_cache()
    return results


# The surface-light-field stages. Phase 27: the SLF material stage on
# synthetic_spheres.gin with the variate bound (spheres binds it off, and
# JAX then cannot run the stage: its material_ray_sampler finds no sampler
# weights on the memory's queries) and phase 21's weights, so that every
# ported term has a value and a gradient.
TRAINER_SLF_STAGE = (
    "Trainer.stage = 'material_surface_light_field_light'", "Trainer.resample = True",
    "Trainer.resample_render = True", "MaterialModel.slf_variate = True",
    "Config.material_smoothness_weight_albedo = 0.0001",
    "Config.material_smoothness_weight_other = 0.0001",
    "Config.cache_consistency_loss_weight = 0.1",
    "Config.material_ray_sampler_interlevel_loss_mult = 1.0",
    "MaterialMLP.stopgrad_shading_weight = 1e-2", "MaterialMLP.stopgrad_cache_weight = (1e2, 1e-4)")
# The leveled kernel per SLF material step on spheres: the cache's primary
# samples, the variate's cache queries (the main pass queries the memory,
# which has no grid), material smoothness's "geometry" pass and the light
# sampler's grid; the variate's light-sampler call has no graph.
_TRAINER_SLF_LAUNCHES_PER_STEP = {"leveled": 4}
_TRAINER_SLF_TERMS = ("data", "cache_data", "light_sampling", "material_ray_sampler",
                      "material_smoothness", "direct_indirect_consistency",
                      "material_surface_light_field")
# A warm-started material stage binds Config.material_interlevel_loss_mults,
# (0, 0) by default, as its interlevel multipliers: material_ray_sampler's
# interlevel term is 0 there (in JAX too), and on spheres it has no other.
_TRAINER_SLF_ZERO_TERMS = ("material_ray_sampler",)
# Phase 28: the README's recipe (the `_resample` suffix) for the SLF material
# stage, and the batches it tries; then the cache-side stage's step.
TRAINER_SLF_COMMAND = ("-c", "ngp_yobo", "-t", "material_surface_light_field_light_resample",
                       "--sample_factor", "8", "--render_chunk_size", "1024")
TRAINER_SLF_BATCHES = (1024, 512, 256)
TRAINER_SLF_CACHE_SIDE = ("Trainer.stage = 'surface_light_field_light'",
                          "Config.batch_size = 8192")


def phase_trainer_slf_reference(torch, device, seed):
    """The Trainer's SLF material step on synthetic_spheres.gin, GPU against
    CPU: every loss term and every gradient leaf, the limit bracketed by a
    CPU noise floor (origins +-1 ulp) and two faults planted in the leveled
    kernel; every GPU leveled call held against its plain version."""
    stage = TRAINER_SLF_STAGE

    def step(dev, **kw):
        return _trainer_step(torch, dev, seed, stage=stage, **kw)

    l_cpu, g_cpu, n_cpu = step("cpu")
    floor, floor_at = 0.0, None
    for nudge in (1, -1):
        v, at = _worst_grad_err(step("cpu", nudge=nudge)[1], g_cpu)
        if v >= floor:
            floor, floor_at = v, at
    checked = []
    l_gpu, g_gpu, n_gpu = step(device, checked=checked)
    loss_errs = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    loss_err = max(loss_errs.values())
    err, err_at = _worst_grad_err(g_gpu, g_cpu)
    faults = {f: _worst_grad_err(step(device, fault=f)[1], g_cpu)
              for f in ("taps rotated", "finest level dropped")}
    finite = all(torch.isfinite(g).all() for g in g_gpu.values())
    terms = set(_TRAINER_SLF_TERMS)
    present = terms <= set(l_cpu) and all((l_cpu[k] == 0) == (k in _TRAINER_SLF_ZERO_TERMS)
                                          for k in terms)
    memory = any(k.startswith("cache.surface_lf_mem.") and bool(g.abs().max() > 0)
                 for k, g in g_gpu.items())
    tol = TRAINER_MATERIAL_GRAD_REL_L2_TOL
    expected = _launch_counts(**_TRAINER_SLF_LAUNCHES_PER_STEP)
    ok = (finite and present and memory and loss_err <= 1e-3 and n_cpu == _launch_counts()
          and n_gpu == expected and len(checked) == expected["leveled"]
          and all(c["ok"] for c in checked) and floor <= tol and err <= tol
          and all(v > tol for v, _ in faults.values()))
    print(f"trainer SLF reference: Trainer, {TRAINER_REF_CONFIG} "
          f"material_surface_light_field_light (resample, the SLF variate), one step, the same "
          f"weights, batch and draws, gpu vs cpu: loss rel_err max={loss_err:.3e} (tol 1e-3; "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(loss_errs.items()))
          + f") grad rel_l2_err max={err:.3e} at {err_at} (tol {tol}; noise floor, cpu vs cpu "
          f"with origins +-1 ulp: {floor:.3e} at {floor_at}; planted in the leveled kernel "
          + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
          + f", each must exceed the tol); the memory's gradient nonzero={memory}; the leveled "
          "calls against their plain version: "
          + "; ".join(f"idx{list(c['shape'])} max_abs_err={c['max_abs_err']:.3e} "
                      f"{'ok' if c['ok'] else 'FAIL'}" for c in checked)
          + f"; kernel launches gpu={n_gpu} cpu={n_cpu} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the Trainer's GPU SLF step disagrees with its CPU step")
    return dict(loss_rel_err=loss_err, loss_rel_errs=loss_errs, grad_rel_l2_err=err,
                grad_err_at=err_at, noise_floor=floor,
                faults={f: v for f, (v, _) in faults.items()}, tol=tol,
                launches=n_gpu["leveled"], max_abs_err=max(c["max_abs_err"] for c in checked),
                losses=l_gpu)


def _slf_cache_side_step(torch, device, seed):
    """Two steps of the cache-side surface_light_field_light stage on the
    full-width ngp_yobo.gin at batch 8192 (the second timed by host clock
    ending in a sync): its losses, ms, peak GiB and launches."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    trainer = _trainer_setup(torch, device, TRAINER_CONFIG, TRAINER_SLF_CACHE_SIDE)
    rng = torch.Generator().manual_seed(seed + 7)
    batches = [trainer.dataset.next_train() for _ in range(2)]
    trainer.state, _ = trainer.train_step(rng, trainer.state, batches[0], 0.5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scatter_cuda.reset_launch_count()
    t0 = time.perf_counter()
    trainer.state, stats = trainer.train_step(rng, trainer.state, batches[1], 0.5)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    losses = {k: float(torch.as_tensor(v).detach()) for k, v in stats["losses"].items()}
    out = dict(step_ms=dt * 1e3, rays_per_s=trainer.batch_size / dt,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, batch=trainer.batch_size,
               launches=dict(scatter_cuda.launches), losses=losses,
               memory=hasattr(trainer.model.cache, "surface_lf_mem"))
    del trainer
    return out


def phase_trainer_slf_train(torch, device, seed, steps, smi, tmp, cache_ckpt):
    """material_surface_light_field_light_resample on the full-width
    ngp_yobo.gin through the train_with_trainer entry point, in-process,
    warm-started from phase 20's checkpoint, at the largest batch of
    TRAINER_SLF_BATCHES that fits: 3 warmup + N timed steps, a second run
    that resumes and takes no step, one eval view; then one step of the
    cache-side stage at batch 8192."""
    import gc
    import os

    from neural_radiance_caching_tpu_torch import train_one_stage
    from neural_radiance_caching_tpu_torch.engine import gin_config

    warmup, cut = 3, []
    for batch in TRAINER_SLF_BATCHES:
        ckpt = os.path.join(tmp, f"ngp_yobo_material_surface_light_field_light_{batch}")
        command = train_one_stage.stage_command(
            list(TRAINER_SLF_COMMAND) + ["--batch_size", str(batch), "--device", device],
            checkpoint_dir=ckpt, partial_checkpoint_dir=cache_ckpt)
        command = [c for c in command[3:] if c != "--logtostderr"]
        extra = [f"--gin_bindings={b}" for b in TRAINER_BINDINGS + (
            f"Config.early_exit_steps = {warmup + steps}",
            f"Config.print_every = {warmup + steps}", f"Config.jax_rng_seed = {20200823 + seed}")]
        resume = [c for c in command if "partial_checkpoint_dir" not in c]
        try:
            run = _entry_point_run(torch, command + extra, resume + extra, ckpt, warmup, steps)
            break
        except torch.cuda.OutOfMemoryError as e:
            allocated = torch.cuda.memory_allocated() / 2**30
            reserved = torch.cuda.memory_reserved() / 2**30
            print(f"trainer SLF train: batch {batch} ran out of memory ({allocated:.2f} GiB "
                  f"allocated, {reserved:.2f} GiB reserved at the failing request): "
                  f"{str(e).splitlines()[0]}", flush=True)
            cut.append(dict(batch=batch, allocated_gib=allocated, reserved_gib=reserved))
            del e
            gin_config.clear_config()
            gc.collect()
            torch.cuda.empty_cache()
    else:
        raise AssertionError(f"no batch of {TRAINER_SLF_BATCHES} fits the SLF stage")
    trainer, dt, losses, log, total = (run["trainer"], run["step_s"], run["losses"], run["log"],
                                       run["total"])
    terms = [f"loss/{k}" for k in _TRAINER_SLF_TERMS]
    finite = _finite(losses.values()) and all(k in losses for k in terms)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    shader = trainer.model.shader
    metrics = run["metrics"]
    cfg = trainer.config
    ok = (finite and run["saved"] == total and run["resume_ok"] and trainer.model.slf_variate
          and run["launches"] == _launch_counts() and math.isfinite(metrics["psnr"])
          and _lpips_ok(metrics))
    cut_text = (f"batch {batch}, cut from {TRAINER_SLF_BATCHES[0]} ("
                + ", ".join(f"{c['batch']} ran out of memory at {c['allocated_gib']:.2f} GiB "
                            f"allocated, {c['reserved_gib']:.2f} reserved" for c in cut)
                + ")" if cut else f"batch {batch}")
    print(f"trainer SLF train: train_with_trainer {TRAINER_CONFIG} "
          f"{' '.join(TRAINER_SLF_COMMAND[2:])} warm-started from the cache stage "
          f"({n_params} params, {shader.num_secondary_samples} memory queries and "
          f"{shader.num_secondary_samples_diff} cache queries per surface point) {cut_text}, "
          f"{warmup} warmup + {steps} timed steps: step_ms={dt * 1e3:.2f} "
          f"rays_per_s={batch / dt:.0f} (train_log rays_per_sec={log[-1]['rays_per_sec']:.0f} "
          f"over steps 2-{total}) on [{smi}]; peak {run['peak_gib']:.2f} GiB; losses finite and "
          f"present={finite} {losses}; checkpoint step {run['saved']}, resumed with no step="
          f"{run['resume_ok']}; kernel launches={run['launches']} (expected none); eval view "
          f"{run['view']} at chunk {cfg.render_chunk_size}: psnr={metrics['psnr']:.2f} "
          f"{_lpips_text(metrics)} in "
          f"{run['eval_s']:.2f}s; entry point {run['wall']:.1f}s {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("trainer SLF train phase failed")
    result = dict(step_ms=dt * 1e3, rays_per_s=batch / dt,
                  train_log_rays_per_s=log[-1]["rays_per_sec"], peak_gib=run["peak_gib"],
                  batch=batch, cut=cut, steps=steps, warmup=warmup, params=n_params,
                  memory_queries_per_point=shader.num_secondary_samples,
                  cache_queries_per_point=shader.num_secondary_samples_diff,
                  launches=run["launches"]["leveled"], eval_view=run["view"],
                  eval_psnr=metrics["psnr"], eval_lpips=metrics["lpips"],
                  eval_s=run["eval_s"], entry_point_s=run["wall"],
                  losses=losses)
    del trainer, run
    gin_config.clear_config()
    gc.collect()
    torch.cuda.empty_cache()
    side = _slf_cache_side_step(torch, device, seed)
    side_ok = (_finite(side["losses"].values()) and not side["memory"]
               and side["losses"].get("material_surface_light_field") == 0.0
               and side["launches"] == _launch_counts())
    print(f"trainer SLF train, cache side: {TRAINER_CONFIG} surface_light_field_light batch "
          f"{side['batch']}, one step after one: step_ms={side['step_ms']:.2f} rays_per_s="
          f"{side['rays_per_s']:.0f} on [{smi}]; peak {side['peak_gib']:.2f} GiB; no SLF memory="
          f"{not side['memory']}; losses {side['losses']}; kernel launches={side['launches']} "
          f"(expected none) {'ok' if side_ok else 'FAIL'}", flush=True)
    if not side_ok:
        raise AssertionError("trainer SLF train phase failed (cache side)")
    result["cache_side"] = {k: v for k, v in side.items() if k not in ("launches", "memory")}
    result["cache_side"]["launches"] = side["launches"]["leveled"]
    gin_config.clear_config()
    return result


# InvProp's other scenes, run without their data (statue_fwp without its
# calibration checkpoint, whose file is not in the repository): name ->
# (gin file, bindings). Phase 29 runs their cache stages at phase 23's
# widths with 96 bins (statue's Gaussian filter of 10.21 bins has 83 taps).
INVPROP_SCENES = {
    "statue_fwp": ("configs/transient_simulation_ngp_yobo_statue_fwp.gin",
                   ("Config.calib_checkpoint = ''",)),
    "kettle_fwp": ("configs/transient_simulation_ngp_yobo_kettle_fwp.gin", ()),
    "cornell_steady_state": ("configs/transient_simulation_ngp_yobo_cornell_steady_state.gin",
                             ()),
}
INVPROP_NARROW = TRANSIENT_NARROW + ("Config.n_bins = 96",)
# Phase 30's runs: (scene, stage, batches to try, timed steps or None for
# --trainer-steps, leveled launches per step).
INVPROP_RUNS = (
    ("statue_fwp", "cache", (8192, 4096, 2048), None, 1),
    ("statue_fwp", "material_light_from_scratch", (4096, 2048, 1024), 3, 6),
    ("kettle_fwp", "cache", (8192, 4096), None, 1),
    ("cornell_steady_state", "cache", (8192, 4096), None, 1),
)


def phase_trainer_invprop_reference(torch, device, seed):
    """Phase 23's method on the cache stages of statue_fwp, kettle_fwp and
    cornell_steady_state at reference widths; then statue's temporal filter
    alone at full width, GPU against CPU."""
    from neural_radiance_caching_tpu_torch.ops import render

    out = {}
    for scene, (config_file, extra) in INVPROP_SCENES.items():
        r = _gpu_vs_cpu_step(torch, device, seed, TRAINER_CACHE_STAGE + INVPROP_NARROW + extra,
                             config_file, launches={"leveled": 1}, terms=("data", "cache_data"))
        print(f"trainer InvProp reference ({scene}): Trainer, {config_file} cache stage at "
              f"reference widths (96 bins, batch 64), one step, the same weights, batch and "
              f"draws, gpu vs cpu: {_gpu_vs_cpu_text(r)}; the leveled call against its plain "
              f"version: {_checked_text(r['checked'])}; kernel launches gpu={r['launches']} "
              f"cpu={r['cpu_launches']} {'ok' if r['ok'] else 'FAIL'}", flush=True)
        if not r["ok"]:
            raise AssertionError(f"the Trainer's GPU {scene} step disagrees with its CPU step")
        out[scene] = {k: v for k, v in r.items()
                      if k not in ("ok", "checked", "cpu_launches", "grad_rel_l2_errs")}

    # Statue's filter alone: the Gaussian of 10.21 bins over [4096, 1933, 1].
    gen = torch.Generator().manual_seed(seed + 29)
    x_cpu = torch.rand((4096, 1933, 1), generator=gen)
    probe = torch.randn((4096, 1933, 1), generator=gen)
    filt = render.gaussian_filter(10.21)

    def run(x, p, f):
        x = x.clone().requires_grad_()
        y = render.convolve_bins(x, f)
        (y * p).sum().backward()
        return y.detach(), x.grad

    y_cpu, g_cpu = run(x_cpu, probe, filt)
    x_gpu, p_gpu, f_gpu = x_cpu.to(device), probe.to(device), filt.to(device)
    y_gpu, g_gpu = run(x_gpu, p_gpu, f_gpu)
    err = float((y_gpu.cpu() - y_cpu).abs().max() / y_cpu.abs().max())
    grad_err = float((g_gpu.cpu() - g_cpu).abs().max() / g_cpu.abs().max())
    fwd_ms = _cuda_ms(lambda: render.convolve_bins(x_gpu, f_gpu))
    x_req = x_gpu.clone().requires_grad_()
    both_ms = _cuda_ms(lambda: (render.convolve_bins(x_req, f_gpu) * p_gpu).sum().backward())
    nbytes = 4 * 2 * x_cpu.numel()
    bound_ms, bound_by = _bound(nbytes, 2 * x_cpu.numel() * filt.numel())
    ok = err <= 1e-5 and grad_err <= 1e-5
    print(f"trainer InvProp reference (filter): statue's Gaussian of 10.21 bins ({filt.numel()} "
          f"taps, one conv1d over the bins with cuDNN's TF32 off) on [4096, 1933, 1], gpu vs "
          f"cpu: max_abs_err/scale={err:.3e}, its backward's {grad_err:.3e} (tol 1e-5); forward "
          f"{fwd_ms:.4f} ms, forward + backward of a probe {both_ms:.4f} ms (medians of 11 by "
          f"CUDA events; bound of the forward {bound_ms:.4f} ms, {bound_by}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the GPU temporal filter disagrees with the CPU's")
    out["filter"] = dict(shape=[4096, 1933, 1], taps=filt.numel(), max_rel_err=err,
                         grad_max_rel_err=grad_err, forward_ms=fwd_ms,
                         forward_backward_ms=both_ms, bound_ms=bound_ms, bound_by=bound_by)
    return out


def _filter_timer(torch):
    """(patch, events): render._correlate_bins (the filter's conv1d, forward
    and backward) with CUDA events around each call."""
    from neural_radiance_caching_tpu_torch.ops import render

    real, events = render._correlate_bins, []

    def timed(x, taps, left):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(x, taps, left)
        end.record()
        events.append((start, end))
        return out

    return (render, {"_correlate_bins": timed}), events


def phase_trainer_invprop_train(torch, device, seed, steps, smi, tmp):
    """INVPROP_RUNS through the train_with_trainer entry point, in-process:
    each at the largest of its batches that fits (a cut printed with the
    memory at the failing request), 3 warmup + N timed steps, the filter's
    conv1d time per step, the checkpoint, a resuming run, one test view;
    then one step with every leveled call held against its plain version.
    statue's material stage warm-starts from its cache stage's checkpoint."""
    return _entry_point_runs(torch, "InvProp", INVPROP_RUNS, INVPROP_SCENES, seed, steps, smi,
                             tmp)[0]


def _out_of_memory(torch, label, batch, error):
    """Print a batch's out-of-memory cut with the memory at the failing
    request; returns its record."""
    allocated = torch.cuda.memory_allocated() / 2**30
    reserved = torch.cuda.memory_reserved() / 2**30
    print(f"{label}: batch {batch} ran out of memory ({allocated:.2f} GiB allocated, "
          f"{reserved:.2f} GiB reserved at the failing request): {str(error).splitlines()[0]}",
          flush=True)
    return dict(batch=batch, allocated_gib=allocated, reserved_gib=reserved)


def _cut_text(batch, batches, cut):
    return (f"batch {batch}, cut from {batches[0]} ("
            + ", ".join(f"{c['batch']} ran out of memory at {c['allocated_gib']:.2f} GiB "
                        f"allocated, {c['reserved_gib']:.2f} reserved" for c in cut)
            + ")" if cut else f"batch {batch}")


def _checked_step(torch, trainer, per_step, capture=None):
    """One train step of `trainer` with every scatter call of the kinds in
    `per_step` held against its plain version (`_checking_scatter`; with
    `capture`, {kind: {}}, each kind's largest call's inputs kept there).
    Returns (the calls, the launch counts of the step, its stats)."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    calls = []
    scatter_cuda.reset_launch_count()
    with _patched(scatter_cuda, **{
            f"scatter_add_weighted_{kind}": _checking_scatter(
                kind, calls, None if capture is None else capture[kind], largest=True)
            for kind in per_step}):
        trainer.state, stats = trainer.train_step(trainer.rng, trainer.state,
                                                  trainer.dataset.next_train(), 0.5)
    return calls, dict(scatter_cuda.launches), stats


def _entry_point_runs(torch, label, runs, scenes, seed, steps, smi, tmp):
    """`runs`, (scene, stage, batches, timed steps or None for `steps`,
    launches per step: a leveled count, or a function of the batch giving
    the counts by kernel), through the train_with_trainer entry point,
    in-process: each at the largest of its batches that fits, 3 warmup +
    the timed steps (the launch counts set to 0 before the run and read
    after it), the filter's conv1d time per step, the checkpoint, a
    resuming run, one test view; then one step with every scatter call held
    against its plain version, the inputs of each kernel's largest call
    kept. A material stage warm-starts from its scene's cache stage run
    before it. Returns (results by run, captured inputs by run and kernel)."""
    import gc
    import os

    from neural_radiance_caching_tpu_torch.engine import gin_config

    warmup, results, ckpts, captures = 3, {}, {}, {}
    for scene, stage, batches, timed_steps, expected in runs:
        config_file, extra = scenes[scene]
        timed = timed_steps or steps
        cut = []
        for batch in batches:
            ckpt = os.path.join(tmp, f"{scene}_{stage}_{batch}")
            common = TRAINER_BINDINGS + extra + (
                f"Trainer.stage = '{stage}'", f"Config.batch_size = {batch}",
                f"Config.checkpoint_dir = '{ckpt}'", f"Config.early_exit_steps = {warmup + timed}",
                f"Config.print_every = {warmup + timed}",
                f"Config.jax_rng_seed = {20200823 + seed}", "Trainer.save_results = False")
            if stage != "cache":
                common += TRANSIENT_MATERIAL_RECIPE
            resume = [f"--gin_configs={config_file}"] + [f"--gin_bindings={b}" for b in common]
            args = resume + ([f"--gin_bindings=Config.partial_checkpoint_dir = "
                              f"'{ckpts[scene]}'"] if stage != "cache" else [])
            patch, events = _filter_timer(torch)
            try:
                run = _entry_point_run(torch, args, resume, ckpt, warmup, timed, (patch,))
                break
            except torch.cuda.OutOfMemoryError as e:
                cut.append(_out_of_memory(torch, f"trainer {label} train ({scene} {stage})",
                                          batch, e))
                del e
                events.clear()
                gin_config.clear_config()
                gc.collect()
                torch.cuda.empty_cache()
        else:
            raise AssertionError(f"no batch of {batches} fits {scene}'s {stage} stage")
        trainer, dt, losses, log, total = (run["trainer"], run["step_s"], run["losses"],
                                           run["log"], run["total"])
        torch.cuda.synchronize()
        filter_ms = sum(s.elapsed_time(e) for s, e in events) / total
        filter_calls = len(events) / total
        events.clear()
        cfg = trainer.config
        finite = _finite(losses.values()) and all(f"loss/{k}" in losses
                                                  for k in ("data", "cache_data"))
        per_step = (expected(batch) if callable(expected) else {"leveled": expected})
        per_step_text = ", ".join(f"{n} {k}" for k, n in per_step.items())

        capture = {kind: {} for kind in per_step}
        calls, checked_launches, stats = _checked_step(torch, trainer, per_step, capture)
        ok = (finite and run["saved"] == total and run["resume_ok"]
              and run["launches"] == _launch_counts(**{k: n * total
                                                       for k, n in per_step.items()})
              and bool(torch.isfinite(stats["loss"])) and len(calls) == sum(per_step.values())
              and all(c["ok"] for c in calls)
              and checked_launches == _launch_counts(**per_step)
              and (filter_calls > 0) == (cfg.tfilter_sigma != 0.0)
              and _lpips_ok(run["metrics"]))
        n_params = sum(p.numel() for p in trainer.model.parameters())
        metrics = run["metrics"]
        print(f"trainer {label} train ({scene} {stage}): train_with_trainer {config_file} "
              f"{stage}{' warm-started from its cache stage' if stage != 'cache' else ''} "
              f"({n_params} params, {cfg.n_bins} bins x {cfg.num_rgb_channels} channel(s), "
              f"tfilter_sigma={cfg.tfilter_sigma}, occlusions={cfg.use_occlusions}, vignette="
              f"{getattr(trainer.model, 'use_vignette', False)}) {_cut_text(batch, batches, cut)}, "
              f"{warmup} warmup + "
              f"{timed} timed steps: step_ms={dt * 1e3:.2f} rays_per_s={batch / dt:.0f} "
              f"(train_log rays_per_sec={log[-1]['rays_per_sec']:.0f} over steps 2-{total}) on "
              f"[{smi}]; peak {run['peak_gib']:.2f} GiB; the filter's conv1d {filter_ms:.3f} ms "
              f"per step ({filter_calls:.0f} calls per step, forward and backward, CUDA events, "
              f"{100 * filter_ms / (dt * 1e3):.2f}% of the step); losses finite and present="
              f"{finite} {losses}; checkpoint step {run['saved']}, resumed with no step="
              f"{run['resume_ok']}; kernel launches={run['launches']} (expected "
              f"{per_step_text} per step); eval view {run['view']} cast on the host: psnr="
              f"{metrics['psnr']:.2f} {_lpips_text(metrics)} "
              f"in {run['eval_s']:.2f}s; checked step, every scatter call "
              f"against its plain version (tol=|err|<={SUM_ORDER_TOL}*sum|w*ct|): "
              + "; ".join(f"{c['kind']} idx{list(c['shape'])} max_abs_err={c['max_abs_err']:.3e} "
                          f"{'ok' if c['ok'] else 'FAIL'}" for c in calls)
              + f"; entry point {run['wall']:.1f}s {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"trainer {label} train phase failed ({scene} {stage})")
        results[f"{scene}_{stage}"] = dict(
            step_ms=dt * 1e3, rays_per_s=batch / dt, train_log_rays_per_s=log[-1]["rays_per_sec"],
            peak_gib=run["peak_gib"], batch=batch, cut=cut, steps=timed, warmup=warmup,
            params=n_params, n_bins=cfg.n_bins, channels=cfg.num_rgb_channels,
            filter_ms_per_step=filter_ms, filter_calls_per_step=filter_calls,
            launches=run["launches"]["leveled"], launches_by_kernel={
                k: run["launches"][k] for k in per_step},
            launches_per_step=per_step.get("leveled", 0), launches_per_step_by_kernel=per_step,
            eval_view=run["view"], eval_psnr=metrics["psnr"], eval_lpips=metrics["lpips"],
            eval_s=run["eval_s"],
            entry_point_s=run["wall"], losses=losses,
            max_abs_err=max(c["max_abs_err"] for c in calls),
            max_abs_err_by_kernel={k: max(c["max_abs_err"] for c in calls if c["kind"] == k)
                                   for k in per_step})
        captures[f"{scene}_{stage}"] = capture
        ckpts[scene] = ckpt
        del trainer, run, stats
        gin_config.clear_config()
        gc.collect()
        torch.cuda.empty_cache()
    return results, captures


# Phases 31-32: InvProp's baseline scenes (the passive transient shader of
# cornell_fwp, the zero transient of cornell_tnerf) and the SLF distance
# head and grids of the nero / open families, without their data; open's far
# plane of 2 ends SyntheticSpheres' rays before its spheres, so it takes
# nero's 4.
BASELINE_SCENES = {
    "cornell_fwp": ("configs/transient_simulation_ngp_yobo_cornell_fwp.gin", ()),
    "cornell_tnerf": ("configs/transient_simulation_ngp_yobo_cornell_tnerf.gin", ()),
    "nero_bell": ("configs/nero_ngp_yobo_bell.gin", ()),
    "open_egg": ("configs/open_ngp_yobo_egg.gin", ("Config.far = 4.0",)),
}
# ngp_yobo.gin's cache stage at phase 31's widths: 16-wide MLPs, a 4096-row
# final grid, 16 samples per level, batch 64 (the scene's SLF narrowed by
# _narrow_slf_binding).
_NGP_LEVEL = ("{'disable_density_normals': True, 'enable_pred_normals': False, "
              "'normals_for_filter_only': True, 'use_grid': False, 'max_deg_point': 4, "
              "'net_depth': 2, 'net_width': 16}")
NGP_NARROW = (
    "Config.batch_size = 64", "Config.num_dataset_images = 4",
    "ProposalVolumeSampler.sampling_strategy = ((0, 0, 16), (1, 1, 16), (2, 2, 16))",
    "NeRFModel.train_sampling_strategy = ((0, 0, 16), (1, 1, 16), (2, 2, 16))",
    "NeRFModel.render_sampling_strategy = ((0, 0, 16), (1, 1, 16), (2, 2, 16))",
    f"ProposalVolumeSampler.mlp_params_per_level = ({_NGP_LEVEL}, {_NGP_LEVEL}, "
    "{'disable_density_normals': False, 'enable_pred_normals': True, "
    "'normals_for_filter_only': False, 'net_depth': 2, 'net_width': 16})",
    "ProposalVolumeSampler.grid_params_per_level = (None, None, "
    "{'hash_map_size': 4096, 'max_grid_size': 128, 'num_features': 4})",
    "NeRFMLP.net_width = 16", "NeRFMLP.bottleneck_width = 16",
    "NeRFMLP.net_width_integrated_brdf = 8", "SurfaceLightFieldMLP.bottleneck_viewdirs = 16")
# Phase 31's leveled launches per step: the cornell scenes' appearance grid;
# the reflectance grid (nero, open) and the SLF's own grid (open).
BASELINE_REFERENCE_LAUNCHES = {"cornell_fwp": 1, "cornell_tnerf": 1, "nero_bell": 1,
                               "open_egg": 2}
# The final level's samples per ray (ngp_yobo.gin) and the distance head's
# points per sample: the reflectance grid's points per ray.
NGP_FINAL_SAMPLES = 32
SLF_DISTANCE_SAMPLES = 8


def _open_launches(batch, trainer=None):
    """open's table-gradient launches per step at `batch`: the SLF's own
    grid at the final samples (leveled at every batch of phase 32), the
    reflectance grid at 8 points each (planes from PLANES_MIN_POINTS)."""
    from neural_radiance_caching_tpu_torch.ops import hashgrid

    points = batch * NGP_FINAL_SAMPLES * SLF_DISTANCE_SAMPLES
    if hashgrid.use_planes_layout(points, "mean"):
        return {"leveled": 1, "planes": 1}
    return {"leveled": 2}


# Phase 32's runs, as INVPROP_RUNS.
BASELINE_RUNS = (
    ("cornell_fwp", "cache", (8192, 4096, 2048), None, 1),
    ("cornell_tnerf", "cache", (8192, 4096, 2048), None, 1),
    ("open_egg", "cache", (8192, 4096, 2048), None, _open_launches),
)


def _narrow_slf_binding(config_file, options=None, narrow=True):
    """The scene's NeRFMLP.surface_lf_params at phase 31's widths (unless
    `narrow` is False): 16-wide trunks, distance and density heads,
    4096-row grids (the own grid's largest level 128); with `options`
    (phase 47's option sets) changed."""
    from neural_radiance_caching_tpu_torch.engine import configs, gin_config

    gin_config.clear_config()
    configs.load_config(config_files=[config_file], bindings=[])
    params = dict(gin_config.query_parameter("NeRFMLP.surface_lf_params"))
    gin_config.clear_config()
    if narrow:
        params.update(net_width=16, net_width_viewdirs=16, net_width_distance=16,
                      reflectance_grid_params=dict(params["reflectance_grid_params"],
                                                   hash_map_size=4096),
                      grid_params=dict(params["grid_params"], hash_map_size=4096,
                                       max_grid_size=128))
        if (options or {}).get("use_density_prediction"):
            params["net_width_density"] = 16
    params.update(options or {})
    return f"NeRFMLP.surface_lf_params = {params!r}"


def phase_trainer_baseline_reference(torch, device, seed):
    """Phase 23's method on the cache stages of cornell_fwp (the passive
    shader) and cornell_tnerf (the zero transient) at its widths, and of
    nero_ngp_yobo_bell (the SLF's distance head over the shader's
    bottleneck, its reflectance grid) and open_ngp_yobo_egg (the origins'
    encoding, the SLF's own grid) at NGP_NARROW's: every loss term and every
    gradient leaf of one step GPU against CPU, each limit bracketed by its
    CPU noise floor and two faults planted in the leveled kernel; every
    leveled launch held against its plain version."""
    out = {}
    for scene, (config_file, extra) in BASELINE_SCENES.items():
        narrow = (TRANSIENT_NARROW if "transient" in config_file
                  else NGP_NARROW + (_narrow_slf_binding(config_file),))
        r = _gpu_vs_cpu_step(torch, device, seed, TRAINER_CACHE_STAGE + narrow + extra,
                             config_file,
                             launches={"leveled": BASELINE_REFERENCE_LAUNCHES[scene]},
                             terms=("data", "cache_data"))
        print(f"trainer baseline reference ({scene}): Trainer, {config_file} cache stage at "
              f"reference widths (batch 64, 16 samples per level"
              f"{', 64 bins' if 'transient' in config_file else ''}), one step, the same "
              f"weights, batch and draws, gpu vs cpu: {_gpu_vs_cpu_text(r)}; the leveled calls "
              f"against their plain version: {_checked_text(r['checked'])}; kernel launches "
              f"gpu={r['launches']} cpu={r['cpu_launches']} {'ok' if r['ok'] else 'FAIL'}",
              flush=True)
        if not r["ok"]:
            raise AssertionError(f"the Trainer's GPU {scene} step disagrees with its CPU step")
        out[scene] = {k: v for k, v in r.items()
                      if k not in ("ok", "checked", "cpu_launches", "grad_rel_l2_errs")}
    return out


def phase_trainer_baseline_train(torch, device, seed, steps, smi, tmp):
    """BASELINE_RUNS through the entry point (`_entry_point_runs`), then
    open's two SLF table-gradient calls of its checked step (the reflectance
    grid's and the own grid's) timed against index_add_ on their inputs."""
    from neural_radiance_caching_tpu_torch.ops import hashgrid

    results, captures = _entry_point_runs(torch, "baseline", BASELINE_RUNS, BASELINE_SCENES,
                                          seed, steps, smi, tmp)
    sizes = [int(v) for v in hashgrid.compute_grid_sizes(16, 256, 1.0)]
    open_capture = captures["open_egg_cache"]
    paths = {}
    for kind, capture in open_capture.items():
        if kind == "planes" or len(open_capture) == 1:
            label = "reflectance grid's updates (open_egg, 8 points per sample)"
        else:
            label = "SLF's own grid's updates (open_egg)"
        # With both calls leveled, the largest one kept is the reflectance grid's.
        paths[f"open_{kind}"] = phase_kernel_path(kind, capture, sizes, label)
    del captures, open_capture
    return results, paths


# Phases 33-34: training from posed images on disk. The scenes are written in
# each loader's on-disk layout without PIL (the script's own PNG writer, the
# scanline filters cycling through all five row by row; EXRs through the
# port's codec), rendered on the card from the procedural spheres scene, and
# read back by the port's loaders through its own PNG and EXR readers.
DISK_SCENES = {
    "hotdog": "configs/nerf_ngp_yobo_hotdog.gin",
    "orb_teapot": "configs/orb_ngp_yobo_teapot.gin",
    "nero_bell": "configs/nero_ngp_yobo_bell.gin",
}
# Each scene's near plane (phases 33-34 and 37-38), restored after
# TRAINER_BINDINGS' data-free one.
DISK_NEAR = {"hotdog": 2.0, "orb_teapot": 0.25, "nero_bell": 1.0, "open_egg": 0.25,
             "neilf_castel": 0.25, "glossy_bear": 0.1, "colmap_garden": 0.2,
             "colmap_garden_in_step": 0.2}
# (views of the train split, of the test split, resolution[, the test
# split's resolution]) at phase 34, the captures' layouts, their view counts
# cut to keep the script inside its time limit: TensoIR's hotdog (20 of its
# 100 train views of 800^2 RGBA, 30 until phase 47 came; 4 of its 200 test
# views, written at 200^2: its material stage's held-out view took 51 s at
# 800^2, and the vis_only evaluation renders one more), ORB's teapot (2048^2
# EXR read at factor 4; 14 train and 2 test views, 20 train until phase 47:
# the capture's counts are not in the repository and each view is a 48 MiB
# FLOAT EXR), NeRO's bell (14 of its 128 views of 800^2, 20 until phase 47,
# every 8th held out by synthetic_split_128.pkl, all trained on).
DISK_SIZES = {"hotdog": (20, 4, 800, 200), "orb_teapot": (14, 2, 2048), "nero_bell": (14, 4, 800)}
# Phase 33's: small scenes of the same layouts.
DISK_REFERENCE_SIZES = {"hotdog": (6, 2, 64), "orb_teapot": (6, 2, 128),
                        "nero_bell": (8, 2, 64)}
# World radius of the cameras and scale of the spheres scene per layout:
# nerf-synthetic's cameras at ~4 units (near 2, far 6), NeRO's at 2.5 (near
# 1, far 4); ORB's loader recentres the poses and scales the farthest train
# camera coordinate to 1, which puts the cameras 1.07 from the scene's
# centre and its surfaces 0.71-1.43 away, inside near 0.25 / far 2.
DISK_CAMERAS = {"hotdog": (4.0, 1.0), "orb_teapot": (3.0, 0.8), "nero_bell": (2.5, 0.7)}
# nerf-synthetic's horizontal field of view; the other layouts' focal length
# is 1.2 x the width.
BLENDER_CAMERA_ANGLE_X = 0.6911112070083618
# Leveled launches of one phase-33 step at NGP_NARROW: none on the hotdog
# (its final density level takes density normals, the plain encoder), the
# reflectance grid on nero, and on orb the SLF's own grid too.
DISK_REFERENCE_LAUNCHES = {"hotdog": 0, "orb_teapot": 2, "nero_bell": 1}


def _png_bytes(samples, color, depth, level=6):
    """PNG bytes of `samples` [H, W, C] (8-bit, or 16-bit values) as colour
    type `color` at `depth` bits, the scanline filters None, Sub, Up,
    Average and Paeth in turn, row by row."""
    import struct
    import zlib

    import numpy as np

    from neural_radiance_caching_tpu_torch.data import png

    h, w = samples.shape[:2]
    flat = samples.reshape(h, w, -1)
    raw = (flat.astype(">u2").view(np.uint8) if depth == 16 else flat.astype(np.uint8))
    raw = raw.reshape(h, -1).astype(np.int16)
    bpp = raw.shape[1] // w
    a, b, c = np.zeros_like(raw), np.zeros_like(raw), np.zeros_like(raw)
    a[:, bpp:] = raw[:, :-bpp]
    b[1:] = raw[:-1]
    c[1:, bpp:] = raw[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    kinds = np.arange(h) % 5
    pred = np.zeros_like(raw)
    for k, p in ((1, a), (2, b), (3, (a + b) >> 1), (4, paeth)):
        pred[kinds == k] = p[kinds == k]
    rows = np.concatenate([kinds[:, None], (raw - pred) & 0xFF], 1).astype(np.uint8)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


def _as_pil_reads(samples, color, depth):
    """What PIL's array of a PNG of `samples` is (and so the port's reader
    must give): 16-bit RGB(A) keeps the high bytes, 16-bit grey + alpha
    becomes RGBA, 16-bit grey keeps its values, grey loses its channel."""
    import numpy as np

    if depth == 8:
        samples = samples.astype(np.uint8)
        return samples[..., 0] if color == 0 else samples
    if color == 0:
        return samples[..., 0].astype(np.uint16)
    high = (samples >> 8).astype(np.uint8)
    if color == 4:
        return np.concatenate([high[..., :1].repeat(3, -1), high[..., 1:]], -1)
    return high


# The script's baseline JPEG writer (the card's machine has no PIL): the
# sample tables of ITU-T T.81 Annex K (K.1 quantisation, natural order; K.3
# Huffman code counts by length and symbols) and the zigzag order.
JPEG_LUMA_Q = (
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99)
JPEG_CHROMA_Q = (
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99) + (99,) * 32
_JPEG_AC_LUMA_SYMBOLS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0243362"
    "7282090a161718191a25262728292a3435363738393a434445464748494a535455565758"
    "595a636465666768696a737475767778797a838485868788898a92939495969798999aa2"
    "a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1"
    "e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_JPEG_AC_CHROMA_SYMBOLS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d1"
    "0a162434e125f11718191a262728292a35363738393a434445464748494a535455565758595a6364"
    "65666768696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5"
    "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5"
    "e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
JPEG_HUFFMAN = {  # (class, table id) -> (counts of code lengths 1-16, symbols)
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), _JPEG_AC_LUMA_SYMBOLS),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), _JPEG_AC_CHROMA_SYMBOLS),
}
JPEG_ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)


def jpeg_qtable(base, quality):
    """An Annex K table scaled by libjpeg's quality rule (jcparam.c), kept in
    [1, 255] for a baseline file."""
    import numpy as np

    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((np.asarray(base, np.int64) * scale + 50) // 100, 1, 255)


def _dct_matrix():
    import numpy as np

    u, x = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    m = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


def _huffman_codes(counts, symbols):
    """The canonical codes of a DHT table (T.81 Annex C): code and length
    per symbol, [256] each."""
    import numpy as np

    code, k = 0, 0
    codes, lengths = np.zeros(256, np.int64), np.zeros(256, np.int64)
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            codes[symbols[k]], lengths[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return codes, lengths


def _magnitude(v):
    """T.81's size category of each value and its extra bits."""
    import numpy as np

    a = np.abs(v)
    size = np.zeros_like(a)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return size, np.where(v >= 0, v, v + (1 << size) - 1)


def _entropy_segment(zz, comp, table, tables):
    """Huffman-code the blocks `zz` [N, 64] (zigzag order) in coding order,
    `comp` [N] each block's component (its DC predictor, which starts at 0)
    and `table` [N] its table id (0 luma, 1 chroma). Vectorised: every symbol and its extra bits become one
    (value, bit count) event, ordered by block and position, and the events
    are laid out by their cumulative bit offsets. Returns the byte-stuffed
    bytes, padded with 1 bits."""
    import numpy as np

    n = zz.shape[0]
    dc = zz[:, 0].astype(np.int64)
    diff = np.zeros(n, np.int64)
    for c in np.unique(comp):
        sel = np.nonzero(comp == c)[0]
        diff[sel] = np.diff(dc[sel], prepend=0)
    size, extra = _magnitude(diff)
    code, length = (np.stack([tables[(0, c)][i] for c in (0, 1)])[table, size] for i in (0, 1))
    blocks, keys = [np.arange(n)], [np.zeros(n, np.int64)]
    values, bits = [(code << size) | extra], [length + size]

    ac = zz[:, 1:].astype(np.int64)
    b, k = np.nonzero(ac)
    k = k + 1
    first = np.r_[True, b[1:] != b[:-1]]
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    size, extra = _magnitude(ac[b, k - 1])
    symbol = ((run % 16) << 4) | size
    code, length = (np.stack([tables[(1, c)][i] for c in (0, 1)])[table[b], symbol]
                    for i in (0, 1))
    blocks.append(b), keys.append(2 * k)
    values.append((code << size) | extra), bits.append(length + size)
    zrl = np.repeat(np.arange(len(b)), run // 16)  # sixteen zeros each
    zcode, zlength = (np.stack([tables[(1, c)][i] for c in (0, 1)])[table[b[zrl]], 0xF0]
                      for i in (0, 1))
    blocks.append(b[zrl]), keys.append(2 * k[zrl] - 1)
    values.append(zcode), bits.append(zlength)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)
    eob = np.nonzero(last < 63)[0]
    ecode, elength = (np.stack([tables[(1, c)][i] for c in (0, 1)])[table[eob], 0x00]
                      for i in (0, 1))
    blocks.append(eob), keys.append(np.full(len(eob), 200))
    values.append(ecode), bits.append(elength)

    order = np.argsort(np.concatenate(blocks) * 256 + np.concatenate(keys), kind="stable")
    values, bits = np.concatenate(values)[order], np.concatenate(bits)[order]
    ends = np.cumsum(bits)
    event = np.repeat(np.arange(len(bits)), bits)
    offset = np.arange(ends[-1] if len(ends) else 0) - np.repeat(ends - bits, bits)
    stream = (values[event] >> (bits[event] - 1 - offset)) & 1
    stream = np.concatenate([stream, np.ones(-len(stream) % 8, np.int64)])
    data = np.packbits(stream.astype(np.uint8))
    stuffed = np.repeat(data, 1 + (data == 0xFF))
    stuffed[np.nonzero(data == 0xFF)[0] + np.arange(1, (data == 0xFF).sum() + 1)] = 0
    return stuffed.tobytes()


def jpeg_encode(rgb, quality=95, restart_interval=0, interleaved=True):
    """A baseline JPEG of `rgb` [H, W, 3] (uint8): YCbCr 4:2:0 (JFIF's
    colour transform, the chroma averaged over 2x2), the forward DCT as 8x8
    matrix products, the Annex K quantisation tables at `quality` and
    Huffman tables, every `restart_interval` MCUs an RSTn marker; with
    `interleaved=False` each component in a scan of its own. Returns (the
    file's bytes, the quantised coefficients of each component [block rows,
    block cols, 64] in natural order, the quantisation tables)."""
    import struct

    import numpy as np

    h, w = rgb.shape[:2]
    x = rgb.astype(np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    ycc = [0.299 * r + 0.587 * g + 0.114 * b,
           -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
           0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    mx, my = -(-w // 16), -(-h // 16)
    quant = [jpeg_qtable(JPEG_LUMA_Q, quality), jpeg_qtable(JPEG_CHROMA_Q, quality)]
    dct = _dct_matrix()
    natural = np.asarray(JPEG_ZIGZAG)
    coeffs, used = [], []
    for ci, plane in enumerate(ycc):
        if ci:
            plane = np.pad(plane, ((0, h % 2), (0, w % 2)), mode="edge")
            plane = plane.reshape(plane.shape[0] // 2, 2, plane.shape[1] // 2, 2).mean((1, 3))
        f = 2 if ci == 0 else 1
        plane = np.pad(plane, ((0, my * 8 * f - plane.shape[0]), (0, mx * 8 * f - plane.shape[1])),
                       mode="edge") - 128.0
        blocks = plane.reshape(my * f, 8, mx * f, 8).transpose(0, 2, 1, 3)
        freq = dct @ blocks @ dct.T
        q = quant[min(ci, 1)].reshape(8, 8)
        coeffs.append(np.rint(freq / q).astype(np.int64).reshape(my * f, mx * f, 64))
        size = (-(-h * f // 2), -(-w * f // 2))
        used.append((-(-size[0] // 8), -(-size[1] // 8)))
    tables = {key: _huffman_codes(*spec) for key, spec in JPEG_HUFFMAN.items()}

    def scan(sequence, comp_ids, n_units):
        """The coded segments of `sequence` [units, blocks per unit, 64]
        (natural order) of components `comp_ids` [blocks per unit],
        restarted every restart_interval units."""
        zz = sequence[..., natural]
        step = restart_interval or n_units
        out = b""
        for i, start in enumerate(range(0, n_units, step)):
            part = zz[start:start + step]
            comp = np.broadcast_to(comp_ids, part.shape[:2]).reshape(-1)
            out += _entropy_segment(part.reshape(-1, 64), comp, np.minimum(comp, 1), tables)
            if start + step < n_units:
                out += bytes([0xFF, 0xD0 + i % 8])
        return out

    def segment(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload

    header = (b"\xff\xd8" + segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
              + segment(0xDB, b"".join(bytes([i]) + bytes(q[natural].astype(np.uint8).tolist())
                                       for i, q in enumerate(quant)))
              + segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
              + segment(0xC4, b"".join(bytes([(cls << 4) | tid]) + bytes(counts) + symbols
                                       for (cls, tid), (counts, symbols) in JPEG_HUFFMAN.items())))
    if restart_interval:
        header += segment(0xDD, struct.pack(">H", restart_interval))
    body = b""
    if interleaved:
        y = coeffs[0].reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
        mcus = np.concatenate([y, coeffs[1].reshape(-1, 1, 64), coeffs[2].reshape(-1, 1, 64)],
                              axis=1)
        body += segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
        body += scan(mcus, np.array([0, 0, 0, 0, 1, 2]), my * mx)
    else:
        for ci in range(3):
            rows, cols = used[ci]
            blocks = coeffs[ci][:rows, :cols].reshape(-1, 1, 64)
            body += segment(0xDA, bytes([1, ci + 1, 0x11 if ci else 0x00, 0, 63, 0]))
            body += scan(blocks, np.array([ci]), rows * cols)
    return header + body + b"\xff\xd9", coeffs, quant


# The decoder's pixels against the writer's float reconstruction: libjpeg's
# integer IDCT, upsampling and colour conversion each round once.
JPEG_FLOAT_TOL = 3


def jpeg_float_reference(coeffs, quant, h, w):
    """The float decode of `jpeg_encode`'s coefficients: dequantised, the
    inverse DCT as matrix products clipped to [0, 255], the chroma upsampled by the triangle
    filter (3/4 near, 1/4 far, the edges repeated), JFIF's YCbCr -> RGB;
    [h, w, 3] float64, unrounded and unclipped."""
    import numpy as np

    dct = _dct_matrix()
    planes = []
    for ci, c in enumerate(coeffs):
        q = quant[min(ci, 1)].reshape(8, 8)
        samples = np.clip(dct.T @ (c.reshape(c.shape[:2] + (8, 8)) * q) @ dct + 128.0, 0, 255)
        plane = samples.transpose(0, 2, 1, 3).reshape(c.shape[0] * 8, c.shape[1] * 8)
        if ci:
            plane = plane[:-(-h // 2), :-(-w // 2)]
            for axis in (0, 1):
                n = plane.shape[axis]
                before = np.take(plane, np.r_[0, np.arange(n - 1)], axis=axis)
                after = np.take(plane, np.r_[np.arange(1, n), n - 1], axis=axis)
                pair = np.stack([0.75 * plane + 0.25 * before, 0.75 * plane + 0.25 * after],
                                axis=axis + 1)
                shape = list(plane.shape)
                shape[axis] *= 2
                plane = pair.reshape(shape)
        planes.append(plane[:h, :w])
    y, cb, cr = planes[0], planes[1] - 128, planes[2] - 128
    return np.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr, y + 1.772 * cb], -1)


def _write(path, data):
    import os

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _trace_spheres(torch, device, origins, dirs, scale, light=None):
    """The procedural spheres (SyntheticSpheres.SPHERES scaled by `scale`,
    lambertian under its point light, or the point `light` before the
    scaling, and its ambient term) along rays `origins`, `dirs` [N, 3]
    (unit) on the card: (rgb [N, 3] in [0, 1], white where no sphere is hit;
    the hit mask; the hit's distance along the ray, inf where none; the hit
    points)."""
    from neural_radiance_caching_tpu_torch.data import datasets

    light = torch.as_tensor(datasets.SyntheticSpheres.LIGHT if light is None else light,
                            dtype=torch.float32, device=device) * scale
    ambient = datasets.SyntheticSpheres.AMBIENT
    best = torch.full(dirs.shape[:1], float("inf"), device=device)
    rgb = torch.ones_like(dirs)
    for center, radius, albedo in datasets.SyntheticSpheres.SPHERES:
        center = torch.tensor(center, device=device) * scale
        oc = origins - center
        b = (oc * dirs).sum(-1)
        disc = b * b - ((oc * oc).sum(-1) - (radius * scale) ** 2)
        t = -b - torch.sqrt(disc.clamp(min=0))
        hit = (disc > 0) & (t > 1e-3) & (t < best)
        p = origins + t[:, None] * dirs
        normal = (p - center) / (radius * scale)
        to_light = light - p
        lambert = ((normal * to_light).sum(-1, keepdim=True)
                   / to_light.norm(dim=-1, keepdim=True)).clamp(min=0)
        shade = torch.tensor(albedo, device=device) * (ambient + (1 - ambient) * lambert)
        rgb = torch.where(hit[:, None], shade, rgb)
        best = torch.where(hit, t, best)
    alpha = torch.isfinite(best)
    points = origins + torch.where(alpha, best, torch.zeros_like(best))[:, None] * dirs
    return rgb, alpha, best, points


def _render_spheres(torch, device, c2w, pixtocam, size, scale, center=(0.0, 0.0, 0.0),
                    distortion=None, light=None):
    """The procedural spheres (scaled by `scale`, moved to `center`, lit by
    `_trace_spheres`' `light`) seen by each camera of `c2w` [N, 3, 4]
    through `pixtocam` [3, 3] (or one [3, 3] per camera) at size^2 (or
    size = (height, width)), with OpenCV's `distortion` (a dict of floats,
    inverted by the port's Newton solve) where given, on the card, one view
    at a time: yields (rgb [h, w, 3] in [0, 1], alpha, the hit's distance
    along the ray, 15 where none) as host arrays."""
    from neural_radiance_caching_tpu_torch.data import camera_utils

    h, w = (size, size) if isinstance(size, int) else size
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32),
                            indexing="ij")
    pixtocams = torch.as_tensor(pixtocam, dtype=torch.float32, device=device)
    shift = torch.tensor(center, dtype=torch.float32, device=device)
    for i, pose in enumerate(c2w):
        cam = torch.as_tensor(pose, dtype=torch.float32, device=device)[None]
        pix = pixtocams[i:i + 1] if pixtocams.dim() == 3 else pixtocams[None]
        rays = camera_utils.pixels_to_rays(xs.reshape(-1), ys.reshape(-1), pix, cam,
                                           distortion_params=distortion)
        rgb, alpha, best, _ = _trace_spheres(torch, device, rays[0] - shift, rays[2], scale,
                                             light)
        depth = torch.where(alpha, best, torch.full_like(best, 15.0))
        yield (rgb.reshape(h, w, 3).cpu().numpy(), alpha.reshape(h, w).float().cpu().numpy(),
               depth.reshape(h, w).cpu().numpy())


def _frames(poses, split, **meta):
    import numpy as np

    frames = []
    for i, pose in enumerate(poses):
        m = np.eye(4)
        m[:3] = pose
        frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": m.tolist()})
    return dict(meta, frames=frames)


def write_disk_scene(torch, device, scene, root, sizes, pool):
    """`scene`'s capture layout in `root` at `sizes` (train views, test
    views, resolution[, the test views' resolution]), the views rendered on the card and encoded by the
    `pool`'s threads: hotdog as TensoIR's blender scenes (transforms JSONs
    with camera_angle_x, 8-bit RGBA PNGs), orb_teapot as ORB's (per-frame
    intrinsics, RGB FLOAT EXRs, 8-bit `{split}_mask` PNGs), nero_bell as
    NeRO's glossy synthetic scenes (`{i}-camera.pkl`, 8-bit RGBA and 16-bit
    depth PNGs, `../synthetic_split_128.pkl`). Returns (the data_dir, bytes
    written, files)."""
    import json
    import os
    import pickle

    import numpy as np

    from neural_radiance_caching_tpu_torch.data import camera_utils, exr

    n_train, n_test, size, *test_size = sizes
    radius, scale = DISK_CAMERAS[scene]
    jobs = []

    def png_job(path, samples, color, depth):
        jobs.append(pool.submit(lambda: _write(path, _png_bytes(samples, color, depth))))

    if scene == "nero_bell":
        data_dir = os.path.join(root, "bell")
        n = n_train
        test_ids = [str(i) for i in range(0, n, n // n_test)][:n_test]
        _write(os.path.join(root, "synthetic_split_128.pkl"), pickle.dumps(
            (test_ids, [str(i) for i in range(n) if str(i) not in test_ids])))
        poses = camera_utils.generate_spherical_poses(n, radius=radius, seed=61)
        k = np.array([[1.2 * size, 0, size / 2], [0, 1.2 * size, size / 2], [0, 0, 1]])
        views = _render_spheres(torch, device, poses, np.linalg.inv(k), size, scale)
        for i, (pose, (rgb, alpha, depth)) in enumerate(zip(poses, views)):
            c2w_cv = np.eye(4)
            c2w_cv[:3] = pose
            c2w_cv = c2w_cv @ np.diag([1.0, -1.0, -1.0, 1.0])
            _write(os.path.join(data_dir, f"{i}-camera.pkl"),
                   pickle.dumps((np.linalg.inv(c2w_cv)[:3], k)))
            rgba = np.concatenate([rgb, alpha[..., None]], -1)
            png_job(os.path.join(data_dir, f"{i}.png"), np.round(rgba * 255), 6, 8)
            png_job(os.path.join(data_dir, f"{i}-depth.png"),
                    np.round(np.minimum(depth, 15.0) / 15 * 65535)[..., None], 0, 16)
    else:
        data_dir = root
        for s, (split, n) in enumerate((("train", n_train), ("test", n_test))):
            if split == "test" and test_size:
                size = test_size[0]
            poses = camera_utils.generate_spherical_poses(n, radius=radius, seed=51 + s)
            if scene == "hotdog":
                focal = 0.5 * size / np.tan(0.5 * BLENDER_CAMERA_ANGLE_X)
                meta = _frames(poses, split, camera_angle_x=BLENDER_CAMERA_ANGLE_X)
            else:
                focal = 1.2 * size
                meta = _frames(poses, split, w=size, h=size)
                for f in meta["frames"]:
                    f.update(fl_x=focal, fl_y=focal, cx=size / 2, cy=size / 2)
            _write(os.path.join(root, f"transforms_{split}.json"), json.dumps(meta).encode())
            views = _render_spheres(torch, device, poses,
                                    camera_utils.get_pixtocam(focal, size, size), size, scale)
            for i, (rgb, alpha, _) in enumerate(views):
                if scene == "hotdog":
                    rgba = np.concatenate([rgb, alpha[..., None]], -1)
                    png_job(os.path.join(root, split, f"r_{i}.png"), np.round(rgba * 255), 6, 8)
                else:
                    path = os.path.join(root, split, f"r_{i}.exr")
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    jobs.append(pool.submit(exr.write_exr, path, rgb * 1.5))
                    png_job(os.path.join(root, f"{split}_mask", f"r_{i}.png"),
                            np.round(alpha * 255)[..., None], 0, 8)
    for job in jobs:
        job.result()
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]
    return data_dir, sum(os.path.getsize(f) for f in files), len(files)


_DISK_LOADERS = {"hotdog": "blender", "orb_teapot": "orb", "nero_bell": "glossy_synthetic",
                 "open_egg": "open_illum", "neilf_castel": "neilf", "glossy_bear": "glossy_real",
                 "colmap_garden": "llff", "colmap_garden_in_step": "llff"}


def _disk_bindings(scene, data_dir):
    """The scene's loader, data_dir and near plane over TRAINER_BINDINGS'
    data-free ones."""
    return (f"Config.dataset_loader = '{_DISK_LOADERS[scene]}'", f"Config.data_dir = '{data_dir}'",
            f"Config.near = {DISK_NEAR[scene]}")


def phase_disk_reference(torch, device, seed, tmp):
    """The port's readers decode what the script's writers wrote, exactly:
    PNGs of every colour type at 8 and 16 bits with the five filters in
    turn (as PIL reads them) and FLOAT EXRs. Then each scene at
    DISK_REFERENCE_SIZES: the loader serving the card gives the CPU
    loader's first three batches bit for bit, and one cache step at
    NGP_NARROW's widths (the scene's SLF narrowed) runs GPU against CPU
    (`_gpu_vs_cpu_step`: every loss term, every gradient leaf, the CPU
    noise floor, two faults planted in the leveled kernel where the step
    launches it, every launch held against its plain version)."""
    import concurrent.futures
    import os

    import numpy as np

    from neural_radiance_caching_tpu_torch.data import datasets, exr, png
    from neural_radiance_caching_tpu_torch.engine import configs, gin_config

    rng = np.random.RandomState(seed)
    decoded = {}
    for color in sorted(png.CHANNELS):
        for depth in (8, 16):
            samples = rng.randint(0, 2**depth, (67, 45, png.CHANNELS[color]))
            got = png.decode_png(_png_bytes(samples, color, depth))
            want = _as_pil_reads(samples, color, depth)
            decoded[f"type{color}_{depth}bit"] = bool(got.dtype == want.dtype
                                                      and np.array_equal(got, want))
    image = rng.uniform(-1, 5, (37, 29, 3)).astype(np.float32)
    path = os.path.join(tmp, "check.exr")
    exr.write_exr(path, image)
    decoded["exr_float"] = bool(np.array_equal(exr.read_exr(path), image))
    print(f"disk reference: the port's PNG reader on the script's PNGs (67x45, filters None, "
          f"Sub, Up, Average, Paeth row by row) and its EXR reader on a FLOAT EXR, equal to what "
          f"was written as PIL reads it: {decoded} {'ok' if all(decoded.values()) else 'FAIL'}",
          flush=True)
    if not all(decoded.values()):
        raise AssertionError("the port's PNG or EXR reader disagrees with what was written")

    out = {"decoded": decoded}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for scene, config_file in DISK_SCENES.items():
            data_dir, _, _ = write_disk_scene(torch, device, scene,
                                              os.path.join(tmp, "disk_reference", scene),
                                              DISK_REFERENCE_SIZES[scene], pool)
            data = _disk_bindings(scene, data_dir)
            narrow = NGP_NARROW + ((_narrow_slf_binding(config_file),)
                                   if scene != "hotdog" else ())
            gin_config.clear_config()
            configs.load_config(config_files=[config_file],
                                bindings=list(TRAINER_BINDINGS + narrow + data))
            config = configs.Config()
            gin_config.clear_config()
            loaded = [datasets.load_dataset("train", data_dir, config, device=dev)
                      for dev in ("cpu", device)]
            same = True
            for _ in range(3):
                want, got = (ds.next_train() for ds in loaded)
                same &= all(
                    (getattr(want.rays, f) is None and getattr(got.rays, f) is None)
                    or torch.equal(getattr(got.rays, f).cpu(), getattr(want.rays, f))
                    for f in ("origins", "directions", "viewdirs", "radii", "cam_idx"))
                same &= torch.equal(got.rgb.cpu(), want.rgb) and torch.equal(
                    got.masks.cpu(), want.masks)
            served = (type(loaded[0]).__name__, tuple(loaded[0].images.shape))
            del loaded
            r = _gpu_vs_cpu_step(torch, device, seed, TRAINER_CACHE_STAGE + narrow + data,
                                 config_file,
                                 launches={"leveled": DISK_REFERENCE_LAUNCHES[scene]},
                                 terms=("data", "cache_data", "mask"))
            ok = r["ok"] and same
            print(f"disk reference ({scene}): {served[0]} loader on {config_file}'s layout "
                  f"(images {list(served[1])}), the card's first three batches equal to the "
                  f"CPU loader's={same}; the cache stage at reference widths (batch 64, 16 "
                  f"samples per level), one step, the same weights, batch and draws, gpu vs cpu: "
                  f"{_gpu_vs_cpu_text(r)}; the leveled calls against their plain version: "
                  f"{_checked_text(r['checked']) or 'none launched'}; kernel launches "
                  f"gpu={r['launches']} cpu={r['cpu_launches']} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise AssertionError(f"the {scene} scene's GPU step or batches disagree with "
                                     "the CPU's")
            out[scene] = {k: v for k, v in r.items()
                          if k not in ("ok", "checked", "cpu_launches", "grad_rel_l2_errs")}
    return out


def _nero_launches(batch, trainer=None):
    """nero's table-gradient launches per step at `batch`: the SLF's
    reflectance grid at 8 points per final sample (planes from
    PLANES_MIN_POINTS); no own grid."""
    from neural_radiance_caching_tpu_torch.ops import hashgrid

    points = batch * NGP_FINAL_SAMPLES * SLF_DISTANCE_SAMPLES
    return {"planes": 1} if hashgrid.use_planes_layout(points, "mean") else {"leveled": 1}


# Phase 34's runs, as `_disk_entry_runs` takes them: the README's two hotdog
# stages (its second at batch 1024, its eval chunk 1024), then the cache
# stages of the teapot and the bell.
DISK_RUNS = (
    ("hotdog", ("--scene", "hotdog", "-t", "cache"), (8192,), None, lambda batch, trainer: {},
     None, ()),
    ("hotdog", ("--scene", "hotdog", "-t", "material_light_from_scratch_resample",
                "--sample_factor", "8", "--render_chunk_size", "1024"), (1024,), "hotdog_cache",
     lambda batch, trainer: {}, None, ("Trainer.vis_secondary = True",)),
    ("orb_teapot", ("--scene", "teapot", "-t", "cache"), (8192, 4096, 2048), None,
     _open_launches, None, ()),
    ("nero_bell", ("--scene", "nero_bell", "-t", "cache"), (8192, 4096, 2048), None,
     _nero_launches, None, ()),
)


def _timed_loading(stats):
    """A patch of the Trainer's dataset loading that records into `stats`
    its wall seconds (train and test splits), the PNG, EXR and JPEG decodes
    and the Lanczos and nearest resizes in it (count and seconds per call,
    each call timed on the loader thread that made it) and the host GiB of
    the loaded arrays."""
    import numpy as np

    from neural_radiance_caching_tpu_torch.data import exr, io as io_lib, jpeg, png
    from neural_radiance_caching_tpu_torch.engine import trainer as trainer_lib

    load = trainer_lib.Trainer._load_datasets
    calls = {"png": [], "exr": [], "jpeg": [], "lanczos": [], "nearest": []}

    def timed(fn, kind):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            calls[kind].append(time.perf_counter() - t0)
            return out
        return call

    def timed_load(self):
        t0 = time.perf_counter()
        with _patched(png, read_png=timed(png.read_png, "png")), \
                _patched(exr, read_exr=timed(exr.read_exr, "exr")), \
                _patched(jpeg, read_jpeg=timed(jpeg.read_jpeg, "jpeg")), \
                _patched(io_lib, resize_lanczos4=timed(io_lib.resize_lanczos4, "lanczos"),
                         resize_nearest=timed(io_lib.resize_nearest, "nearest")):
            load(self)
        stats.update(load_s=time.perf_counter() - t0, host_gib=sum(
            v.nbytes for ds in (self.dataset, self.test_dataset) for v in vars(ds).values()
            if isinstance(v, np.ndarray)) / 2**30)
        for kind, times in calls.items():
            stats[f"{kind}_calls"] = len(times)
            stats[f"{kind}_s"] = sum(times) / max(len(times), 1)

    return trainer_lib.Trainer, {"_load_datasets": timed_load}


def _timed_next_train(stats):
    """A patch of the datasets' shared `next_train` (every loader that
    draws from its stacked images or flattened table) that records into
    `stats["next_train_s"]` each call's host seconds: the draw, the host
    cast or the Pixels, the move to the card."""
    from neural_radiance_caching_tpu_torch.data import datasets

    fn = datasets.Dataset.next_train
    stats["next_train_s"] = []

    def next_train(self):
        t0 = time.perf_counter()
        batch = fn(self)
        stats["next_train_s"].append(time.perf_counter() - t0)
        return batch

    return datasets.Dataset, {"next_train": next_train}


def _probe_capture(probe):
    """A patch of the Trainer's secondary-ray probe that records into
    `probe` the probe rendering's shape, its outputs' count, whether all are
    finite, and its seconds (the render and its host copies)."""
    import numpy as np

    from neural_radiance_caching_tpu_torch.engine import trainer as trainer_lib

    render = trainer_lib.Trainer.render_secondary_rays

    def timed(self, *args):
        t0 = time.perf_counter()
        out = render(self, *args)  # host arrays: the copies end in a sync
        probe.update(s=time.perf_counter() - t0, shape=tuple(out["rgb"].shape),
                     keys=len(out), finite=all(bool(np.isfinite(v).all()) for v in out.values()))
        return out

    return trainer_lib.Trainer, {"render_secondary_rays": timed}


def _loading_text(load):
    """The loading's readings as the disk phases print them."""
    times = sorted(load.get("next_train_s") or [0.0])
    return (f"load {load['load_s']:.2f}s (train and test splits; " + ", ".join(
        f"{load[f'{kind}_calls']} {what} at {load[f'{kind}_s']:.4f}s each"
        for kind, what in (("png", "PNG decodes"), ("exr", "EXR decodes"),
                           ("jpeg", "JPEG decodes"), ("lanczos", "Lanczos-4 resizes"),
                           ("nearest", "nearest resizes"))
        if load[f"{kind}_calls"]) + f"; {load['host_gib']:.3f} GiB of host arrays); "
        f"next_train host ms median {1e3 * times[len(times) // 2]:.2f} max "
        f"{1e3 * times[-1]:.2f} over {len(load.get('next_train_s') or [])} calls")


def phase_disk_train(torch, device, seed, steps, smi, tmp):
    """Each scene written at DISK_SIZES, then DISK_RUNS through the
    train_with_trainer entry point (`_disk_entry_runs`)."""
    import concurrent.futures
    import os

    written = {}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for scene, sizes in DISK_SIZES.items():
            t0 = time.perf_counter()
            data_dir, nbytes, files = write_disk_scene(torch, device, scene,
                                                       os.path.join(tmp, "disk", scene), sizes,
                                                       pool)
            written[scene] = dict(data_dir=data_dir, write_s=time.perf_counter() - t0,
                                  gib=nbytes / 2**30, files=files, train_views=sizes[0],
                                  test_views=sizes[1], resolution=sizes[2],
                                  views=f"{sizes[0]} train views at {sizes[2]}^2")
            print(f"disk train: wrote {scene} ({DISK_SCENES[scene]}'s layout, {sizes[0]} train "
                  f"views at {sizes[2]}^2 + {sizes[1]} test views at {sizes[-1]}^2, rendered on "
                  f"the card): {files} "
                  f"files, {nbytes / 2**30:.3f} GiB in {written[scene]['write_s']:.1f}s",
                  flush=True)
    results = _disk_entry_runs(torch, device, "disk train", DISK_RUNS, written, seed, steps,
                               smi, tmp)
    trained = results["hotdog_material_light_from_scratch_resample"]
    vis_only = _hotdog_vis_only(torch, device, written["hotdog"]["data_dir"], tmp,
                                trained["batch"], trained["warmup"] + trained["steps"])
    return {"written": written, **results, "hotdog_vis_only": vis_only}


def _hotdog_vis_only(torch, device, data_dir, tmp, batch, trained_steps):
    """The README's evaluation command on a steady family: train_one_stage
    --vis_only on the hotdog's material checkpoint that DISK_RUNS trained
    (`batch`, `trained_steps`), over its first test view (Trainer.vis_end =
    1, render chunk 1024): results.txt, the saved render, no kernel launch.
    The blender loader reads no albedo images (in JAX neither), so
    Config.compute_albedo_metrics is left off here; its path is held against
    JAX on the CPU (tests/test_torch_eval_extras.py, the blender_active
    loader)."""
    import json
    import os

    import numpy as np

    from neural_radiance_caching_tpu_torch import train_one_stage, train_with_trainer
    from neural_radiance_caching_tpu_torch.engine import gin_config
    from neural_radiance_caching_tpu_torch.engine import trainer as trainer_lib
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    stage = "material_light_from_scratch_resample"
    ckpt = os.path.join(tmp, f"disk_hotdog_{stage}_{batch}")
    command = train_one_stage.stage_command(
        ["--scene", "hotdog", "-t", stage, "--sample_factor", "8", "--render_chunk_size",
         "1024", "--vis_only", "--device", device, "--gin_bindings=Trainer.vis_end = 1"],
        checkpoint_dir=ckpt)
    args = [c for c in command[3:] if c != "--logtostderr"] + [
        f"--gin_bindings={b}" for b in _disk_bindings("hotdog", data_dir)]
    views, renders = [], []
    evaluate, render = (trainer_lib.Trainer.log_test_set_evaluation,
                        trainer_lib.Trainer.render_test_view)

    def timed(fn, out):
        def call(self, *a):
            t0 = time.perf_counter()
            result = fn(self, *a)
            out.append(time.perf_counter() - t0)
            return result
        return call

    gin_config.clear_config()
    torch.cuda.reset_peak_memory_stats()
    scatter_cuda.reset_launch_count()
    t0 = time.perf_counter()
    with _patched(trainer_lib.Trainer, log_test_set_evaluation=timed(evaluate, views),
                  render_test_view=timed(render, renders)):
        shown = train_with_trainer.main(args)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(scatter_cuda.launches)
    save = os.path.join(ckpt, "save")
    lines = open(os.path.join(save, "results.txt")).read().splitlines()
    metrics = {line.split(": ")[0]: json.loads(line.split(": ", 1)[1]) for line in lines}
    rgb = np.load(os.path.join(save, "color", "000000.npy"))
    cfg = shown.config
    ok = (math.isfinite(metrics["psnr"][0]) and math.isfinite(metrics["lpips"][0])
          and rgb.shape == (shown.test_dataset.height, shown.test_dataset.width, 3)
          and bool(np.isfinite(rgb).all())
          and len(views) == len(renders) == 1 and int(shown.state.step) == trained_steps
          and launches == _launch_counts())
    print(f"disk vis_only: train_one_stage --scene hotdog -t {stage} --vis_only "
          f"(Trainer.vis_end = 1) on the material checkpoint (step {int(shown.state.step)}): the "
          f"test view {rgb.shape[1]}x{rgb.shape[0]}, render chunk {cfg.render_chunk_size}: "
          f"results.txt psnr={metrics['psnr'][0]:.3f} ssim={metrics['ssim'][0]:.4f} lpips="
          f"{metrics['lpips'][0]:.4f}; the eval view took {views[0]:.2f}s, its render "
          f"{renders[0]:.2f}s, of the command's {wall:.1f}s; peak {peak:.2f} GiB; the saved "
          f"render {list(rgb.shape)} finite; kernel launches={launches} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the vis_only evaluation of the hotdog's material stage failed")
    del shown
    gin_config.clear_config()
    return dict(view=f"{rgb.shape[1]}x{rgb.shape[0]}", eval_s_per_image=views[0],
                render_s=renders[0], command_s=wall, peak_gib=peak, psnr=metrics["psnr"][0],
                ssim=metrics["ssim"][0], lpips=metrics["lpips"][0], launches=launches)


def _disk_entry_runs(torch, device, label, runs, written, seed, steps, smi, tmp):
    """`runs`, (scene, train_one_stage arguments, batches to try, the run it
    warm-starts from, launches per step by kernel as a function of the batch
    and the trainer, timed steps or None for `steps`, extra bindings[,
    options: `nan_terms`, the loss terms that must be NaN, as the JAX
    package computes them; `held_out=False`, no held-out view]),
    through the train_with_trainer entry point as train_one_stage builds its
    command, in-process, reading the scene `written[scene]` holds (its
    loader and near plane by `_disk_bindings`), each at
    the largest of its batches that fits, 3 warmup + the timed steps (the
    launch counts set to 0 before and read after): the loading's wall
    seconds, decode and resize seconds per call and host GiB, ms per step,
    rays/s, peak GiB, launches per step, one held-out view's PSNR (unless
    `held_out=False`); then one step with every scatter call held against
    its plain version. No resume run (phases 20-32 hold it). Returns the
    readings by run."""
    import gc
    import os

    from neural_radiance_caching_tpu_torch import train_one_stage
    from neural_radiance_caching_tpu_torch.engine import gin_config

    warmup, results, ckpts = 3, {}, {}
    for scene, argv, batches, warm_from, expected, timed_steps, extra, *options in runs:
        options = options[0] if options else {}
        nan_terms = tuple(options.get("nan_terms", ()))
        held_out = options.get("held_out", True)
        stage = argv[argv.index("-t") + 1]
        timed = timed_steps or steps
        cut = []
        for batch in batches:
            ckpt = os.path.join(tmp, f"disk_{scene}_{stage}_{batch}")
            command = train_one_stage.stage_command(
                list(argv) + ["--batch_size", str(batch), "--device", device],
                checkpoint_dir=ckpt, partial_checkpoint_dir=ckpts.get(warm_from))
            command = [c for c in command[3:] if c != "--logtostderr"]
            args = command + [f"--gin_bindings={b}" for b in _disk_bindings(
                scene, written[scene]["data_dir"]) + tuple(extra) + (
                f"Config.early_exit_steps = {warmup + timed}",
                f"Config.print_every = {warmup + timed}",
                f"Config.jax_rng_seed = {20200823 + seed}", "Trainer.save_results = False")]
            load, probe = {}, {}
            capture_cls, capture = _probe_capture(probe)
            try:
                # The probe runs at the evaluation after the run's train loop.
                with _patched(capture_cls, **capture):
                    run = _entry_point_run(torch, args, None, ckpt, warmup, timed,
                                           (_timed_loading(load), _timed_next_train(load)),
                                           evaluate=held_out)
                break
            except torch.cuda.OutOfMemoryError as e:
                cut.append(_out_of_memory(torch, f"{label} ({scene} {stage})", batch, e))
                del e
                gin_config.clear_config()
                gc.collect()
                torch.cuda.empty_cache()
        else:
            raise AssertionError(f"no batch of {batches} fits {scene}'s {stage} stage")
        trainer, dt, losses, log, total = (run["trainer"], run["step_s"], run["losses"],
                                           run["log"], run["total"])
        per_step = expected(batch, trainer)
        calls, checked_launches, stats = _checked_step(torch, trainer, per_step)
        terms = ("data", "cache_data") + (("mask",) if stage.startswith("cache")
                                          and trainer.dataset.masks is not None else ())
        nan_keys = {f"loss/{k}" for k in nan_terms} | ({"loss"} if nan_terms else set())
        finite = (_finite(v for k, v in losses.items() if k not in nan_keys)
                  and all(f"loss/{k}" in losses for k in terms + nan_terms)
                  and all(losses[k] != losses[k] for k in nan_keys)
                  and all(math.isnan(float(stats["losses"][k])) for k in nan_terms))
        metrics = run["metrics"]
        probed = "Trainer.vis_secondary = True" in extra
        probe_ok = (not probed) or bool(
            probe.get("shape") == (*trainer._probe_resolution(), 3) and probe["finite"])
        ok = (finite and run["saved"] == total and probe_ok
              and run["launches"] == _launch_counts(**{k: n * total for k, n in per_step.items()})
              and bool(torch.isfinite(stats["loss"])) != bool(nan_terms)
              and len(calls) == sum(per_step.values())
              and all(c["ok"] for c in calls) and checked_launches == _launch_counts(**per_step)
              and (not held_out or (math.isfinite(metrics["psnr"]) and _lpips_ok(metrics))))
        n_params = sum(p.numel() for p in trainer.model.parameters())
        name = f"{scene}_{stage}"
        print(f"{label} ({name}): train_with_trainer {' '.join(argv)} "
              f"{'warm-started from ' + warm_from if warm_from else ''} ({n_params} params) on "
              f"{written[scene]['views']} ({type(trainer.dataset).__name__}: "
              f"{trainer.dataset.num_images} images of {trainer.dataset.height}x"
              f"{trainer.dataset.width}), {_cut_text(batch, batches, cut)}, {warmup} warmup + "
              f"{timed} timed steps: {_loading_text(load)}; step_ms={dt * 1e3:.2f} "
              f"rays_per_s={batch / dt:.0f} (train_log rays_per_sec={log[-1]['rays_per_sec']:.0f} "
              f"over steps 2-{total}) on [{smi}]; peak {run['peak_gib']:.2f} GiB; losses finite "
              f"and present={finite}" + (f" ({', '.join(nan_terms)} NaN, as in JAX)"
                                         if nan_terms else "")
              + f" {losses}; checkpoint step {run['saved']}; kernel launches="
              f"{run['launches']} (expected {per_step or 'none'} per step); "
              + (f"held-out view {run['view']}: psnr={metrics['psnr']:.2f} "
                 f"{_lpips_text(metrics)} in {run['eval_s']:.2f}s" if held_out
                 else "no held-out view") + (
                  f" (the secondary-ray probe from the pixel 0.3 across and 0.6 down: "
                  f"{probe['shape'][0]}x{probe['shape'][1]} rays through the cache, "
                  f"{probe['keys']} outputs finite={probe['finite']} in {probe['s']:.2f}s)"
                  if probed else "") + "; checked step, "
              f"every scatter call against its plain version (tol=|err|<={SUM_ORDER_TOL}"
              f"*sum|w*ct|): " + ("; ".join(
                  f"{c['kind']} idx{list(c['shape'])} max_abs_err={c['max_abs_err']:.3e} "
                  f"{'ok' if c['ok'] else 'FAIL'}" for c in calls) or "none launched")
              + f"; entry point {run['wall']:.1f}s {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{label} phase failed ({name})")
        results[name] = dict(
            step_ms=dt * 1e3, rays_per_s=batch / dt, train_log_rays_per_s=log[-1]["rays_per_sec"],
            peak_gib=run["peak_gib"], batch=batch, cut=cut, steps=timed, warmup=warmup,
            params=n_params, load=load, launches_by_kernel={
                k: run["launches"][k] for k in ("leveled", "planes")},
            launches_per_step_by_kernel=per_step, eval_view=run["view"] if held_out else None,
            eval_psnr=metrics and metrics["psnr"], eval_lpips=metrics and metrics["lpips"],
            eval_s=run["eval_s"], entry_point_s=run["wall"], probe=probe or None,
            losses=losses, max_abs_err_by_kernel={
                k: max(c["max_abs_err"] for c in calls if c["kind"] == k) for k in per_step})
        ckpts[name] = ckpt
        del trainer, run, stats
        gin_config.clear_config()
        gc.collect()
        torch.cuda.empty_cache()
    return results


# Phases 35-36: InvProp's scenes in their captures' layout on disk, read by
# the port's transient loaders through its own HDF5 reader: name -> (gin
# file, loader, the config's near plane, camera radius and the spheres'
# scale, so that every direct path lands inside the config's bins).
TRANSIENT_DISK_SCENES = {
    "cornell": (TRANSIENT_CONFIG, "transient_simulation", 0.7, 3.5, 1.0),
    "statue_fwp": ("configs/transient_simulation_ngp_yobo_statue_fwp.gin",
                   "fwp_transient_captured", 0.9, 10.0, 2.5),
}
_TRANSIENT_LOADER_CLASSES = {"transient_simulation": "TransientSimulation",
                             "fwp_transient_captured": "FWPTransientCaptured"}
# The layouts' sizes: train views (poses only: the streams hold their
# samples), stream rays, stored bins (the window the config reads starts at
# start_bin), test frames and their size, channels, the bins' exposure.
# Phase 35's frames are 32^2, read at 8^2 (two halvings); its bins are the
# reference widths' (64 for cornell, 96 for statue, whose filter has 83
# taps) from start_bin 4.
TRANSIENT_DISK_REFERENCE_SIZES = {
    "cornell": dict(train_views=4, rays=2048, stored_bins=72, start_bin=4, test_views=2,
                    size=32, test_size=32, channels=3, exposure=0.25),
    "statue_fwp": dict(train_views=4, rays=2048, stored_bins=100, start_bin=4, test_views=2,
                       size=32, test_size=32, channels=1, exposure=0.25),
}
# Phase 36's: cornell's stream of 131,072 rays x 700 bins x 3 (1.10 GB)
# drawn from 256^2 views and one 256^2 test frame (0.55 GB; at the config's
# 512^2 its --vis_only render took 90 s of the script's 1200 s limit);
# statue_fwp's stream of 65,536 rays x
# 3000 bins x 1 (0.79 GB), read from bin 1067, and one test frame at its eval
# size, 128^2 (0.20 GB; a 512^2 one would be 3.1 GB). The captures' own ray
# counts are not in the repository.
TRANSIENT_DISK_SIZES = {
    "cornell": dict(train_views=64, rays=131072, stored_bins=700, start_bin=0, test_views=1,
                    size=256, test_size=256, channels=3, exposure=0.01),
    "statue_fwp": dict(train_views=64, rays=65536, stored_bins=3000, start_bin=1067,
                       test_views=1, size=512, test_size=128, channels=1,
                       exposure=0.010376310322275158),
}
# statue's measured pulse (`./data/yobo/pulse.npy`, 85 bins) is not in the
# repository: a Gaussian of its temporal filter's width stands in for it.
PULSE_BINS, PULSE_SIGMA = 85, 10.21
SIM_CAMERA_ANGLE_X = 0.6911112070083618
FWP_FOCAL_512 = 614.4
DATASET_SCALE = {"cornell": 200.0, "statue_fwp": 600.0}


def _spheres_transients(torch, device, origins, dirs, scale, stored_bins, exposure, channels,
                        gain):
    """The spheres' direct transients along rays `origins`, `dirs` [N, 3]
    on the card: each hit's shade times `gain`, split linearly between the
    two bins around its path length (camera -> surface -> light) over
    `exposure`; [N, stored_bins, channels]."""
    from neural_radiance_caching_tpu_torch.data import datasets

    rgb, alpha, t, points = _trace_spheres(torch, device, origins, dirs, scale)
    light = torch.as_tensor(datasets.SyntheticSpheres.LIGHT, device=device) * scale
    at = (t.nan_to_num(posinf=0.0) + (light - points).norm(dim=-1)) / exposure
    inside = alpha & (at < stored_bins - 1)
    b0 = at.floor().clamp(0, stored_bins - 2).long()
    frac = (at - b0)[:, None]
    value = (rgb if channels == 3 else rgb.mean(-1, keepdim=True)) * gain * inside[:, None]
    out = torch.zeros((dirs.shape[0], stored_bins, channels), device=device)
    rows = torch.arange(dirs.shape[0], device=device)
    out[rows, b0] += value * (1 - frac)
    out[rows, b0 + 1] += value * frac
    return out


def write_transient_scene(torch, device, scene, root, sizes, seed):
    """`scene`'s capture layout in `root` at `sizes`, rendered on the card
    and written by the port's HDF5 writer: `transforms_{train,test}.json`
    (the simulation's camera_angle_x; the FWP rig's per-frame `camera`
    matrices for 512 wide), one `data` frame per test view ([H, W, bins,
    3], the FWP's [H, W, bins]) and the streams `train_efficient/
    {x,y,samples,file_indices}.h5` (dataset `dataset`: random pixels of the
    train views, int64 indices); statue's pulse `pulse.npy`. Returns (the
    (path, dataset name, array) of each h5 file written, the bytes
    written)."""
    import json
    import os

    import numpy as np

    from neural_radiance_caching_tpu_torch.data import camera_utils, hdf5

    _, _, _, radius, scale = TRANSIENT_DISK_SCENES[scene]
    kind = "sim" if scene == "cornell" else "fwp"
    channels, stored, exposure = sizes["channels"], sizes["stored_bins"], sizes["exposure"]
    gain = DATASET_SCALE[scene]
    rng = np.random.RandomState(seed)
    written = []
    os.makedirs(root, exist_ok=True)

    def pixtocam(width):
        if kind == "sim":
            focal = 0.5 * width / np.tan(0.5 * SIM_CAMERA_ANGLE_X)
            return camera_utils.get_pixtocam(focal, width, width)
        k = np.array([[FWP_FOCAL_512, 0, 256.0], [0, FWP_FOCAL_512, 256.0], [0, 0, 1]])
        k = k / int(512 / width)
        k[2, 2] = 1
        return np.linalg.inv(k)

    def write(path, name, array):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        hdf5.write_h5(path, name, array)
        written.append((path, name, array))

    def rays(c2w, pix_x, pix_y, width):
        pix = torch.as_tensor(pixtocam(width), dtype=torch.float32, device=device)
        cams = torch.as_tensor(c2w, dtype=torch.float32, device=device)
        out = camera_utils.pixels_to_rays(pix_x.float(), pix_y.float(),
                                          pix.expand(pix_x.shape[0], 3, 3), cams)
        return out[0], out[2]

    for s, split in enumerate(("train", "test")):
        n = sizes[f"{split}_views"]
        poses = camera_utils.generate_spherical_poses(n, radius=radius, seed=81 + s)
        frames = []
        for i, pose in enumerate(poses):
            m = np.eye(4)
            m[:3] = pose
            frame = {"file_path": f"{split}/{'r_' if kind == 'sim' else '1_'}{i:02d}.h5",
                     "transform_matrix": m.tolist()}
            if kind == "fwp":
                frame["camera"] = [[FWP_FOCAL_512, 0, 256.0], [0, FWP_FOCAL_512, 256.0],
                                   [0, 0, 1]]
            frames.append(frame)
            if split == "test":
                size = sizes["test_size"]
                ys, xs = torch.meshgrid(torch.arange(size, device=device),
                                        torch.arange(size, device=device), indexing="ij")
                o, d = rays(np.repeat(pose[None], size * size, 0), xs.reshape(-1),
                            ys.reshape(-1), size)
                frame_t = _spheres_transients(torch, device, o, d, scale, stored, exposure,
                                              channels, gain).reshape(size, size, stored,
                                                                      channels)
                host = frame_t.cpu().numpy()
                del frame_t
                write(os.path.join(root, frame["file_path"]), "data",
                      host if kind == "sim" else host[..., 0])
        meta = {"frames": frames}
        if kind == "sim":
            meta["camera_angle_x"] = SIM_CAMERA_ANGLE_X
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
        if split == "train":
            train_poses = poses

    n_rays, size = sizes["rays"], sizes["size"]
    view = rng.randint(0, sizes["train_views"], n_rays)
    x, y = rng.randint(0, size, n_rays), rng.randint(0, size, n_rays)
    samples = np.empty((n_rays, stored, channels), np.float32)
    block = 16384
    for start in range(0, n_rays, block):
        sl = slice(start, start + block)
        o, d = rays(train_poses[view[sl]], torch.as_tensor(x[sl], device=device),
                    torch.as_tensor(y[sl], device=device), size)
        samples[sl] = _spheres_transients(torch, device, o, d, scale, stored, exposure,
                                          channels, gain).cpu().numpy()
    eff = os.path.join(root, "train_efficient")
    for name, array in (("file_indices", view.astype(np.int64)), ("x", x.astype(np.int64)),
                        ("y", y.astype(np.int64)), ("samples", samples)):
        write(os.path.join(eff, f"{name}.h5"), "dataset", array)
    if kind == "fwp":
        taps = np.arange(PULSE_BINS) - PULSE_BINS // 2
        pulse = np.exp(-0.5 * (taps / PULSE_SIGMA) ** 2)
        np.save(os.path.join(root, "pulse.npy"), pulse / pulse.sum())
    return written, sum(os.path.getsize(p) for p, _, _ in written)


def _transient_disk_bindings(scene, data_dir, sizes, reference):
    """The scene's loader, files and near plane (over TRAINER_BINDINGS'
    data-free ones); at the reference sizes its frames and bins too."""
    _, loader, near, _, _ = TRANSIENT_DISK_SCENES[scene]
    out = (f"Config.dataset_loader = '{loader}'", f"Config.data_dir = '{data_dir}'",
           f"Config.near = {near}")
    if scene == "statue_fwp":
        out += (f"Config.impulse_response = '{data_dir}/pulse.npy'",
                f"Config.n_impulse_response_bins = {PULSE_BINS}",
                "Config.calib_checkpoint = ''")
    if reference:
        out += (f"Config.width = {sizes['size']}", f"Config.height = {sizes['size']}",
                "Config.test_width = 8", "Config.test_height = 8",
                f"Config.start_bin = {sizes['start_bin']}",
                f"Config.test_start_bin = {sizes['start_bin']}")
    elif scene == "cornell":
        # The views' size: a --vis_only render takes the whole frame.
        out += (f"Config.width = {sizes['size']}", f"Config.height = {sizes['size']}")
    return out


def _same_batch(torch, got, want):
    """A batch served on the card against the CPU loader's, bit for bit:
    its Pixels (or rays) and every supervision field."""
    import dataclasses

    pairs = [(getattr(got.rays, f.name), getattr(want.rays, f.name))
             for f in dataclasses.fields(want.rays)]
    pairs += [(getattr(got, f), getattr(want, f))
              for f in ("rgb", "masks", "alphas", "impulse_response")]
    return all((g is None and w is None) or (
        g is not None and w is not None and torch.equal(torch.as_tensor(g).cpu(),
                                                        torch.as_tensor(w)))
               for g, w in pairs)


def phase_transient_disk_reference(torch, device, seed, tmp):
    """Small scenes in the layouts of cornell's (transient_simulation) and
    statue_fwp's (fwp_transient_captured: per-frame intrinsics, single
    channel, its pulse) captures, rendered on the card and written by the
    port's HDF5 writer: each file read back by the port's reader equal to
    what was written (whole, and the frames through the strided read that
    an eval view makes); the first three batches and an eval view the card
    gets equal to the CPU loader's; one cache step at reference widths GPU
    against CPU (`_gpu_vs_cpu_step`; 1 leveled launch each)."""
    import os

    import numpy as np

    from neural_radiance_caching_tpu_torch.data import datasets, hdf5
    from neural_radiance_caching_tpu_torch.engine import configs, gin_config

    out = {}
    for scene, (config_file, loader, _, _, _) in TRANSIENT_DISK_SCENES.items():
        sizes = TRANSIENT_DISK_REFERENCE_SIZES[scene]
        root = os.path.join(tmp, "transient_reference", scene)
        written, nbytes = write_transient_scene(torch, device, scene, root, sizes, seed)
        round_trip = True
        for path, name, array in written:
            with hdf5.File(path) as f:
                round_trip &= bool(np.array_equal(f[name][()], array))
                if name == "data":
                    round_trip &= bool(np.array_equal(f[name][::4, ::4, 4:68],
                                                      array[::4, ::4, 4:68]))
        narrow = TRANSIENT_NARROW if scene == "cornell" else INVPROP_NARROW
        data = _transient_disk_bindings(scene, root, sizes, reference=True)
        gin_config.clear_config()
        configs.load_config(config_files=[config_file],
                            bindings=list(TRAINER_BINDINGS + narrow + data))
        config = configs.Config()
        gin_config.clear_config()
        same = True
        for split in ("train", "test"):
            loaded = [datasets.load_dataset(split, root, config, device=dev)
                      for dev in ("cpu", device)]
            for _ in range(3 if split == "train" else 1):
                want, got = ((ds.next_train() if split == "train" else ds.generate_ray_batch(1))
                             for ds in loaded)
                same &= _same_batch(torch, got, want)
            for ds in loaded:
                ds.close()
            served = type(loaded[0]).__name__
        r = _gpu_vs_cpu_step(torch, device, seed, TRAINER_CACHE_STAGE + narrow + data,
                             config_file, launches={"leveled": 1}, terms=("data", "cache_data"))
        ok = r["ok"] and same and round_trip
        print(f"transient disk reference ({scene}): {served} loader on {config_file}'s layout "
              f"({sizes['train_views']} train views' stream of {sizes['rays']} rays x "
              f"{sizes['stored_bins']} bins x {sizes['channels']}, {sizes['test_views']} test "
              f"frames of {sizes['test_size']}^2 read at 8^2, rendered on the card, "
              f"{len(written)} files, {nbytes} bytes by the port's HDF5 writer): read back by "
              f"its reader equal to what was written={round_trip}; the card's first three "
              f"batches and an eval view equal to the CPU loader's={same}; the cache stage at "
              f"reference widths (batch 64), one step, the same weights, batch and draws, gpu "
              f"vs cpu: {_gpu_vs_cpu_text(r)}; the leveled call against its plain version: "
              f"{_checked_text(r['checked'])}; kernel launches gpu={r['launches']} "
              f"cpu={r['cpu_launches']} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"the {scene} transient scene's files, batches or GPU step "
                                 "disagree")
        out[scene] = {k: v for k, v in r.items()
                      if k not in ("ok", "checked", "cpu_launches", "grad_rel_l2_errs")}
    return out


# Phase 36's runs through the entry point: (scene, stage, batches to try,
# leveled launches per step). cornell's material stage warm-starts from its
# cache stage; 8192 runs it out of memory (PR 11), as statue's cache stage.
TRANSIENT_DISK_RUNS = (
    ("cornell", "cache", (8192, 4096), 1),
    ("cornell", "material_light_from_scratch", (4096, 2048), 6),
    ("statue_fwp", "cache", (4096, 2048), 1),
)


def _host_timers(stats):
    """Patches that record into `stats` the Trainer's dataset loading (wall
    seconds) and every transient loader's `next_train` (host seconds, the
    window's reads, the batch made and moved to the device)."""
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.engine import trainer as trainer_lib

    load = trainer_lib.Trainer._load_datasets
    stats["next_train_s"] = []

    def timed_load(self):
        t0 = time.perf_counter()
        load(self)
        stats["load_s"] = time.perf_counter() - t0

    def timed_next(fn):
        def next_train(self):
            t0 = time.perf_counter()
            batch = fn(self)
            stats["next_train_s"].append(time.perf_counter() - t0)
            return batch
        return next_train

    return ((trainer_lib.Trainer, {"_load_datasets": timed_load}),
            *((cls, {"next_train": timed_next(cls.next_train)})
              for cls in (datasets.TransientSimulation, datasets.FWPTransientCaptured)))


def phase_transient_disk_train(torch, device, seed, steps, smi, tmp):
    """cornell's and statue_fwp's layouts at TRANSIENT_DISK_SIZES, then
    TRANSIENT_DISK_RUNS through the train_with_trainer entry point,
    in-process, each at the largest of its batches that fits, 3 warmup + N
    timed steps (the launch counts set to 0 before and read after), reading
    its scene from disk: the write and load seconds, ms per step, rays/s,
    peak GiB, leveled launches per step, next_train's host ms (drawn one
    step ahead on the RayBatcher's thread), an eval view's seconds; one step
    with every leveled call held against its plain version. Then the
    README's evaluation command, train_one_stage --vis_only, on cornell's
    cache checkpoint over its first view (Trainer.vis_end = 1): results.txt
    and the view's transient saved as h5, read back by the port's reader
    equal to what the trainer saved."""
    import gc
    import os

    import numpy as np

    from neural_radiance_caching_tpu_torch import train_one_stage, train_with_trainer
    from neural_radiance_caching_tpu_torch.data import hdf5
    from neural_radiance_caching_tpu_torch.engine import gin_config
    from neural_radiance_caching_tpu_torch.engine import trainer as trainer_lib
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    written, roots = {}, {}
    for scene, sizes in TRANSIENT_DISK_SIZES.items():
        t0 = time.perf_counter()
        roots[scene] = os.path.join(tmp, "transient_disk", scene)
        files, nbytes = write_transient_scene(torch, device, scene, roots[scene], sizes, seed)
        written[scene] = dict(write_s=time.perf_counter() - t0, gb=nbytes / 1e9,
                              files=len(files), **sizes)
        del files
        gc.collect()
        print(f"transient disk train: wrote {scene} ({TRANSIENT_DISK_SCENES[scene][0]}'s "
              f"layout, rendered on the card, the port's HDF5 writer): a stream of "
              f"{sizes['rays']} rays x {sizes['stored_bins']} bins x {sizes['channels']} over "
              f"{sizes['train_views']} train views, {sizes['test_views']} test frame(s) of "
              f"{sizes['test_size']}^2; {written[scene]['files']} files, "
              f"{written[scene]['gb']:.3f} GB in {written[scene]['write_s']:.1f}s", flush=True)

    warmup, results, ckpts = 3, {}, {}
    for scene, stage, batches, per_step in TRANSIENT_DISK_RUNS:
        config_file = TRANSIENT_DISK_SCENES[scene][0]
        data = _transient_disk_bindings(scene, roots[scene], TRANSIENT_DISK_SIZES[scene],
                                        reference=False)
        cut = []
        for batch in batches:
            ckpt = os.path.join(tmp, f"transient_disk_{scene}_{stage}_{batch}")
            common = data + (
                f"Trainer.stage = '{stage}'", f"Config.batch_size = {batch}",
                f"Config.checkpoint_dir = '{ckpt}'",
                f"Config.early_exit_steps = {warmup + steps}",
                f"Config.print_every = {warmup + steps}",
                f"Config.jax_rng_seed = {20200823 + seed}", "Trainer.save_results = False")
            if stage != "cache":
                common += TRANSIENT_MATERIAL_RECIPE + (
                    f"Config.partial_checkpoint_dir = '{ckpts[scene]}'",)
            args = ["--device", device, f"--gin_configs={config_file}"] + [
                f"--gin_bindings={b}" for b in common]
            host = {}
            try:
                run = _entry_point_run(torch, args, None, ckpt, warmup, steps,
                                       _host_timers(host))
                break
            except torch.cuda.OutOfMemoryError as e:
                cut.append(_out_of_memory(torch, f"transient disk train ({scene} {stage})",
                                          batch, e))
                del e
                gin_config.clear_config()
                gc.collect()
                torch.cuda.empty_cache()
        else:
            raise AssertionError(f"no batch of {batches} fits {scene}'s {stage} stage")
        trainer, dt, losses, log, total = (run["trainer"], run["step_s"], run["losses"],
                                           run["log"], run["total"])
        calls, checked_launches, stats = _checked_step(torch, trainer, {"leveled": per_step})
        trainer.dataset.close()
        next_ms = 1e3 * np.array(host["next_train_s"])
        finite = _finite(losses.values()) and all(f"loss/{k}" in losses
                                                  for k in ("data", "cache_data"))
        ok = (finite and run["saved"] == total
              and run["launches"] == _launch_counts(leveled=per_step * total)
              and bool(torch.isfinite(stats["loss"])) and len(calls) == per_step
              and all(c["ok"] for c in calls)
              and checked_launches == _launch_counts(leveled=per_step)
              and type(trainer.dataset).__name__ == _TRANSIENT_LOADER_CLASSES[
                  TRANSIENT_DISK_SCENES[scene][1]] and math.isfinite(run["metrics"]["psnr"])
                  and _lpips_ok(run["metrics"]))
        name = f"{scene}_{stage}"
        cfg = trainer.config
        print(f"transient disk train ({name}): train_with_trainer {config_file} {stage}"
              f"{' warm-started from its cache stage' if stage != 'cache' else ''} reading "
              f"its scene ({type(trainer.dataset).__name__}: the stream's bins "
              f"{cfg.start_bin}-{cfg.start_bin + cfg.n_bins} x {cfg.num_rgb_channels}), "
              f"{_cut_text(batch, batches, cut)}, {warmup} warmup + {steps} timed steps: load "
              f"{host['load_s']:.3f}s; step_ms={dt * 1e3:.2f} rays_per_s={batch / dt:.0f} "
              f"(train_log rays_per_sec={log[-1]['rays_per_sec']:.0f} over steps 2-{total}) "
              f"on [{smi}]; peak {run['peak_gib']:.2f} GiB; next_train host ms (the RayBatcher "
              f"thread, one step ahead; {len(next_ms)} calls) median="
              f"{np.median(next_ms):.2f} max={next_ms.max():.2f}; losses finite and present="
              f"{finite} {losses}; checkpoint step {run['saved']}; kernel launches="
              f"{run['launches']} (expected {per_step} leveled per step); eval view "
              f"{run['view']} read from its frame: psnr={run['metrics']['psnr']:.2f} "
              f"{_lpips_text(run['metrics'])} in "
              f"{run['eval_s']:.2f}s; checked step, every leveled call against its plain "
              f"version (tol=|err|<={SUM_ORDER_TOL}*sum|w*ct|): "
              + "; ".join(f"idx{list(c['shape'])} max_abs_err={c['max_abs_err']:.3e} "
                          f"{'ok' if c['ok'] else 'FAIL'}" for c in calls)
              + f"; entry point {run['wall']:.1f}s {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"transient disk train phase failed ({name})")
        results[name] = dict(
            step_ms=dt * 1e3, rays_per_s=batch / dt, train_log_rays_per_s=log[-1]["rays_per_sec"],
            peak_gib=run["peak_gib"], batch=batch, cut=cut, steps=steps, warmup=warmup,
            load_s=host["load_s"], next_train_host_ms_median=float(np.median(next_ms)),
            next_train_host_ms_max=float(next_ms.max()), launches=run["launches"]["leveled"],
            launches_per_step=per_step, eval_view=run["view"], eval_s=run["eval_s"],
            eval_psnr=run["metrics"]["psnr"], eval_lpips=run["metrics"]["lpips"],
            entry_point_s=run["wall"], losses=losses,
            max_abs_err=max(c["max_abs_err"] for c in calls))
        if stage == "cache":
            ckpts[scene] = ckpt
        del trainer, run, stats
        gin_config.clear_config()
        gc.collect()
        torch.cuda.empty_cache()

    # The README's evaluation command on cornell's cache checkpoint.
    ckpt = ckpts["cornell"]
    command = train_one_stage.stage_command(
        ["--scene", "cornell", "-t", "cache", "--vis_only", "--device", device,
         "--gin_bindings=Trainer.vis_end = 1"], checkpoint_dir=ckpt)
    data = _transient_disk_bindings("cornell", roots["cornell"], TRANSIENT_DISK_SIZES["cornell"],
                                    reference=False)
    args = [c for c in command[3:] if c != "--logtostderr"] + [
        f"--gin_bindings={b}" for b in data]
    saved, views, renders = {}, [], []
    write_h5, evaluate = hdf5.write_h5, trainer_lib.Trainer.log_test_set_evaluation
    render = trainer_lib.Trainer.render_test_view

    def timed_render(self, cam_idx, train_frac):
        t0 = time.perf_counter()
        out = render(self, cam_idx, train_frac)
        renders.append(time.perf_counter() - t0)
        return out

    def keep(path, name, array):
        saved[path] = array
        write_h5(path, name, array)

    def timed_eval(self, step, train_frac):
        t0 = time.perf_counter()
        metrics = evaluate(self, step, train_frac)
        views.append(time.perf_counter() - t0)
        return metrics

    gin_config.clear_config()
    torch.cuda.reset_peak_memory_stats()
    scatter_cuda.reset_launch_count()
    t0 = time.perf_counter()
    with _patched(hdf5, write_h5=keep), _patched(
            trainer_lib.Trainer, log_test_set_evaluation=timed_eval,
            render_test_view=timed_render):
        shown = train_with_trainer.main(args)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(scatter_cuda.launches)
    shown.dataset.close()
    lines = open(os.path.join(ckpt, "save", "results.txt")).read().splitlines()
    metrics = {line.split(": ")[0]: json.loads(line.split(": ", 1)[1]) for line in lines}
    path = os.path.join(ckpt, "save", "transients", "000000.h5")
    with hdf5.File(path) as f:
        back = f["data"][()]
    cfg = shown.config
    read_back = bool(path in saved and np.array_equal(back, saved[path]))
    ok = (read_back and back.shape == (cfg.height, cfg.width, cfg.n_bins, 3)
          and bool(np.isfinite(back).all()) and math.isfinite(metrics["psnr"][0])
          and math.isfinite(metrics["lpips"][0])
          and len(views) == len(renders) == 1 and shown.state.step == warmup + steps
          and launches == _launch_counts())
    print(f"transient disk vis_only: train_one_stage --scene cornell -t cache --vis_only "
          f"(Trainer.vis_end = 1) on the cache checkpoint (step {shown.state.step}): the test "
          f"view at Config.height x width = {cfg.height}x{cfg.width}, {cfg.n_bins} bins, with "
          f"vis_only's shadow rays, render chunk {cfg.render_chunk_size}: results.txt "
          f"psnr={metrics['psnr'][0]:.3f} ssim={metrics['ssim'][0]:.4f} lpips="
          f"{metrics['lpips'][0]:.4f} transient_iou="
          f"{metrics['transient_iou'][0]:.4f}; the eval view took {views[0]:.2f}s, its render "
          f"{renders[0]:.2f}s (the frame's read and the host copies included), the metrics, "
          f"vis suite and saves the rest, of the command's {wall:.1f}s; peak {peak:.2f} GiB; the "
          f"saved transient {list(back.shape)} ({back.nbytes / 1e9:.2f} GB) read back by the "
          f"port's reader equal to what was saved={read_back}; kernel launches={launches} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the vis_only evaluation of the cornell scene failed")
    results["cornell_vis_only"] = dict(
        view=f"{cfg.height}x{cfg.width}", n_bins=cfg.n_bins, eval_s_per_image=views[0],
        render_s=renders[0],
        command_s=wall, peak_gib=peak, psnr=metrics["psnr"][0], ssim=metrics["ssim"][0], lpips=metrics["lpips"][0],
        
        transient_iou=metrics["transient_iou"][0], saved_gb=back.nbytes / 1e9)
    del shown, saved, back
    gin_config.clear_config()
    gc.collect()
    torch.cuda.empty_cache()
    return {"written": written, **results}


# Phases 37-38: real captures in JPEG on disk. The scenes are written in the
# layouts of the open_illum (OpenIllumination), neilf (NeILF++) and
# glossy_real (NeRO's real captures) loaders without PIL (the script's JPEG
# writer, 4:2:0 at quality 95, the masks through its PNG writer), rendered
# on the card from the procedural spheres scene, and read back by the
# port's loaders through its own JPEG decoder and its copies of OpenCV's
# resizes.
REAL_SCENES = {
    "open_egg": "configs/open_ngp_yobo_egg.gin",
    "neilf_castel": "configs/neilf_ngp_yobo_castel.gin",
    "glossy_bear": "configs/glossy_ngp_yobo.gin",
}
# (views, held-out views, height, width) at phase 38, cut stand-ins (the
# captures, their view counts and sizes are not in the repository):
# OpenIllumination's egg, 12 train and 4 test views of 2048 x 1536 read at
# the config's factor 2 (its test split at factor 8, so that the held-out
# view is 256 x 192; 20 and 6 before phase 43 read each view under three
# illuminations); NeILF++'s castel, 24 views of 1536 x 1024 of which
# VALIDATION_INDEXES hold out 9, read at factor 4; NeRO's bear, 24 views in
# images_raw_1024 at 1024 x 768 (its probe in images/ at 2048 x 1536), every
# view in both splits.
REAL_SIZES = {"open_egg": (12, 4, 1536, 2048), "neilf_castel": (24, 0, 1024, 1536),
              "glossy_bear": (24, 0, 768, 1024)}
# Phase 37's: the same layouts, small (NeRO's views stay 1024 wide: the
# loader scales the intrinsics to images_raw_1024's size).
REAL_REFERENCE_SIZES = {"open_egg": (4, 2, 64, 96), "neilf_castel": (12, 0, 96, 128),
                        "glossy_bear": (4, 0, 768, 1024)}
# Camera radius and the spheres' scale: OpenIllumination's poses are used as
# stored (cameras 1.3 from the object, inside near 0.25 / far 2); NeILF++'s
# loader scales the farthest camera coordinate to 1; NeRO's aligns the
# poses to their principal axes inside [-1, 1]^3 (the spheres follow it).
REAL_CAMERAS = {"open_egg": (1.3, 0.35), "neilf_castel": (3.7, 0.3), "glossy_bear": (2.5, 0.9)}
# The JPEG writer against the port's decoder on the card's machine:
# (height, width, quality, restart interval, interleaved).
JPEG_CHECKS = {"420_q95": (67, 45, 95, 0, True), "420_q50_restart": (96, 130, 50, 3, True),
               "per_component_q75": (40, 72, 75, 0, False),
               "capture_q95": (1536, 2048, 95, 0, True)}
# Leveled launches of one phase-37 step at NGP_NARROW: the SLF's
# reflectance grid and its own grid, on every one of the three configs.
REAL_REFERENCE_LAUNCHES = 2
# The gradient limit of phase 37's step where it is not GRAD_REL_L2_TOL:
# glossy_ngp_yobo.gin's reflectance grid at NGP_NARROW reads a CPU noise
# floor (the cameras +-1 ulp) of 0.015-0.075 at its level 3 (15 CPU runs
# over seeds, view counts, camera radii and sphere scales), against
# 0.004-0.005 on the other two configs; the planted faults read >= 0.88.
REAL_REFERENCE_GRAD_TOL = {"glossy_bear": 0.15}


def _ply_bytes(points):
    """A binary little-endian PLY of float x, y, z vertices."""
    import numpy as np

    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(points)}\n"
              "property float x\nproperty float y\nproperty float z\nend_header\n")
    return header.encode() + np.asarray(points, "<f4").tobytes()


def write_real_scene(torch, device, scene, root, sizes, pool):
    """`scene`'s capture layout in `root` at `sizes` (views, held-out views,
    height, width), the views rendered on the card and encoded by the
    `pool`'s threads: open_egg as an OpenIllumination object
    (`output/transforms_{split}.json` with OpenCV poses and per-frame
    intrinsics, `Lights/013/raw_undistorted/*.JPG`, grey `com_masks` /
    `obj_masks` PNGs), neilf_castel as a NeILF++ scene (`sfm_scene.json`
    with OpenCV world-to-camera extrinsics, `images/*.jpg`), glossy_bear as
    a NeRO real capture (`cache.pkl`, the probe in `images/`, the views in
    `images_raw_1024/`, `object_point_cloud.ply`). Each view is rendered
    through the cameras the loader will hand the model. Returns (the
    data_dir, bytes written, files)."""
    import json
    import os
    import pickle

    import numpy as np

    from neural_radiance_caching_tpu_torch.data import camera_utils, datasets

    n, n_test, h, w = sizes
    radius, scale = REAL_CAMERAS[scene]
    opencv = np.diag([1.0, -1.0, -1.0, 1.0])
    k = np.array([[1.2 * w, 0, w / 2], [0, 1.2 * w, h / 2], [0, 0, 1]])
    jobs = []

    def pad(pose):
        m = np.eye(4)
        m[:3] = pose[:3, :4]
        return m

    def jpeg_job(path, rgb):
        pixels = np.round(rgb * 255).astype(np.uint8)
        jobs.append(pool.submit(lambda: _write(path, jpeg_encode(pixels, 95)[0])))

    if scene == "open_egg":
        data_dir = os.path.join(root, "obj_02_egg", "output")
        lights = os.path.join(root, "obj_02_egg", "Lights", "013", "raw_undistorted")
        for s, (split, count) in enumerate((("train", n), ("test", n_test))):
            poses = camera_utils.generate_spherical_poses(count, radius=radius, seed=71 + s)
            frames = []
            views = _render_spheres(torch, device, poses, np.linalg.inv(k), (h, w), scale)
            for i, (pose, (rgb, alpha, _)) in enumerate(zip(poses, views)):
                name = f"CA{s}_{i:03d}"
                frames.append({"file_path": f"./images/{name}",
                               "transform_matrix": (pad(pose) @ opencv).tolist(),
                               "fl_x": k[0, 0], "fl_y": k[1, 1], "cx": k[0, 2], "cy": k[1, 2],
                               "w": w, "h": h})
                jpeg_job(os.path.join(lights, f"{name}.JPG"), rgb)
                mask = np.round(alpha * 255)[..., None]
                masks = "com_masks" if split == "train" else "obj_masks"
                jobs.append(pool.submit(lambda p=os.path.join(data_dir, masks, f"{name}.png"),
                                        m=mask: _write(p, _png_bytes(m, 0, 8))))
            _write(os.path.join(data_dir, f"transforms_{split}.json"),
                   json.dumps({"frames": frames}).encode())
    elif scene == "neilf_castel":
        data_dir = root
        raw = camera_utils.generate_spherical_poses(n, radius=radius, seed=81).astype(np.float64)
        # The loader's cameras: the translations scaled by the farthest
        # coordinate, then y and z swapped.
        final = raw.copy()
        final[:, :, 3] /= np.abs(raw[:, :, 3]).max()
        final = np.array([[1.0, 0, 0], [0, 0, 1], [0, 1, 0]]) @ final
        images, cameras = {}, {}
        views = _render_spheres(torch, device, final, np.linalg.inv(k), (h, w), scale)
        for i, (pose, (rgb, _, _)) in enumerate(zip(raw, views)):
            key = str(2 * i + 1)
            images[key] = f"/capture/images/view_{i:03d}.JPG"
            cameras[key] = {"flg": 2, "camera": {
                "intrinsic": {"focal": [k[0, 0], k[1, 1]], "ppt": [k[0, 2], k[1, 2]]},
                "extrinsic": np.linalg.inv(pad(pose) @ opencv).reshape(-1).tolist()}}
            jpeg_job(os.path.join(root, "images", f"view_{i:03d}.jpg"), rgb)
        _write(os.path.join(root, "sfm_scene.json"), json.dumps({
            "camera_track_map": {"images": cameras},
            "image_path": {"file_paths": images}}).encode())
    else:
        data_dir = os.path.join(root, "bear")
        ph, pw = 2 * h, 2 * w  # the probe: the capture's own size
        kp = np.array([[1.2 * pw, 0, pw / 2], [0, 1.2 * pw, ph / 2], [0, 0, 1]])
        center = np.array([0.4, -0.3, 0.2])
        rng = np.random.RandomState(91)
        cloud = center + rng.uniform(-1, 1, (4096, 3)) * scale
        _write(os.path.join(data_dir, "object_point_cloud.ply"), _ply_bytes(cloud))
        raw = camera_utils.generate_spherical_poses(n, radius=radius, center=center, seed=92)
        poses = {i: np.linalg.inv(pad(c) @ opencv)[:3] for i, c in enumerate(raw)}
        names = {i: f"IMG_{i:04d}.jpg" for i in poses}
        _write(os.path.join(data_dir, "cache.pkl"),
               pickle.dumps((poses, {i: kp for i in poses}, names, None)))
        jpeg_job(os.path.join(data_dir, "images", names[1]), np.full((ph, pw, 3), 0.5))
        # The loader's cameras: its normalisation by the point cloud (the
        # cloud's box centre to the origin), then the principal-axis
        # alignment; the spheres sit at the box centre, which the alignment
        # takes to its translation.
        loader = datasets.GlossyReal.__new__(datasets.GlossyReal)
        loader.data_dir, loader.object_name = data_dir, "bear"
        norm = loader._normalize({i: p.copy() for i, p in poses.items()})
        c2w = np.array([np.linalg.inv(pad(norm[i]))[:3, :4] for i in names]) @ opencv
        final, transform = camera_utils.transform_poses_pca(c2w[:, :3, :4])
        points = loader._load_point_cloud(os.path.join(data_dir, "object_point_cloud.ply"))
        box = (points.max(0) + points.min(0)) / 2
        to_final = np.linalg.norm(transform[0, :3]) / np.max(np.linalg.norm(points - box, axis=1))
        k_final = np.diag([w / pw, h / ph, 1.0]) @ kp
        views = _render_spheres(torch, device, final, np.linalg.inv(k_final), (h, w),
                                scale * to_final, tuple(transform[:3, 3]))
        for i, (rgb, _, _) in enumerate(views):
            jpeg_job(os.path.join(data_dir, "images_raw_1024", names[i]), rgb)
    for job in jobs:
        job.result()
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]
    return data_dir, sum(os.path.getsize(f) for f in files), len(files)


def _qvec(r):
    """A rotation matrix as COLMAP's (w, x, y, z) unit quaternion
    (Shepperd's method)."""
    import numpy as np

    t = np.trace(r)
    if t > 0:
        s = 2.0 * np.sqrt(1.0 + t)
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + r[i, i] - r[j, j] - r[k, k])
        q = [0.0] * 4
        q[0] = (r[k, j] - r[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (r[j, i] + r[i, j]) / s
        q[1 + k] = (r[k, i] + r[i, k]) / s
    q = np.array(q)
    return q / np.linalg.norm(q)


def write_colmap_scene(torch, device, root, sizes, pool, seed):
    """A capture in mip-NeRF 360's layout in `root` at `sizes` (views,
    height, width of images_4/), the views rendered on the card and
    JPEG-encoded by the `pool`'s threads: `sparse/0/cameras.bin` (one OPENCV
    camera at 4x the size, COLMAP_DISTORTION), `sparse/0/images.bin` (the
    poses, image ids out of name order), `images_4/*.JPG`. Each view is
    rendered through the camera the llff loader will hand the model: the
    pose after its principal-axis alignment (read back through the port's
    COLMAP reader), the intrinsics at factor 4 and the lens distortion,
    inverted by the port's own Newton solve on the card. Returns (the
    data_dir, bytes written, files, the written poses' largest difference
    from the ones read back)."""
    import os
    import struct

    import numpy as np

    from neural_radiance_caching_tpu_torch.data import camera_utils, colmap

    n, h, w = sizes
    full_h, full_w = COLMAP_FACTOR * h, COLMAP_FACTOR * w
    focal = COLMAP_FOCAL * full_w
    params = [focal, focal, full_w / 2, full_h / 2] + [COLMAP_DISTORTION[k]
                                                        for k in ("k1", "k2", "p1", "p2")]
    radius, scale = COLMAP_CAMERAS
    poses = camera_utils.generate_spherical_poses(n, radius=radius, seed=seed + 101)
    names = [f"_DSC{8000 + 7 * i:04d}.JPG" for i in range(n)]
    ids = np.random.RandomState(seed + 102).permutation(n) + 1
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 4, full_w, full_h)
                + struct.pack("<8d", *params))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        for image_id, pose, name in zip(ids, poses, names):
            m = np.eye(4)
            m[:3] = pose
            w2c = np.linalg.inv(m @ np.diag([1.0, -1.0, -1.0, 1.0]))
            f.write(struct.pack("<idddddddi", int(image_id), *_qvec(w2c[:3, :3]), *w2c[:3, 3], 1)
                    + name.encode() + b"\x00" + struct.pack("<Q", 0))
    read_names, read_poses, pixtocams, distortion, _ = colmap.load_colmap_posedata(root)
    order = np.argsort(names)
    pose_err = float(np.abs(read_poses - poses[order]).max())
    final, transform = camera_utils.transform_poses_pca(read_poses)
    pixtocam = (pixtocams[0] @ np.diag([COLMAP_FACTOR, COLMAP_FACTOR, 1.0])).astype(np.float32)
    views = _render_spheres(torch, device, final, pixtocam, (h, w), scale,
                            tuple(transform[:3, 3]),
                            distortion={k: float(v[0]) for k, v in distortion.items()})
    jobs = []
    for name, (rgb, _, _) in zip(read_names, views):
        pixels = np.round(rgb * 255).astype(np.uint8)
        path = os.path.join(root, "images_4", name)
        jobs.append(pool.submit(lambda p=path, x=pixels: _write(p, jpeg_encode(x, 95)[0])))
    for job in jobs:
        job.result()
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]
    return root, sum(os.path.getsize(f) for f in files), len(files), pose_err


def _jpeg_reference(seed):
    """The script's JPEG writer against the port's decoder: for each case of
    JPEG_CHECKS, the coefficient blocks the C entropy decoder gives equal
    the writer's quantised coefficients (a scan per component: the blocks
    inside each component, the rest zero), and the decoded pixels sit
    within JPEG_FLOAT_TOL of the writer's float reconstruction."""
    import numpy as np

    from neural_radiance_caching_tpu_torch.data import jpeg

    rng = np.random.RandomState(seed)
    out = {}
    for name, (h, w, quality, restart, interleaved) in JPEG_CHECKS.items():
        y, x = np.mgrid[:h, :w]
        img = np.stack([(x * 3 + y * (c + 2)) % 256 for c in range(3)], -1)
        img = np.where(rng.rand(h, w, 1) < 0.1, rng.randint(0, 256, img.shape), img)
        buf, coeffs, quant = jpeg_encode(img.astype(np.uint8), quality, restart, interleaved)
        t0 = time.perf_counter()
        frame = jpeg.decode_coefficients(buf)
        entropy_s = time.perf_counter() - t0
        same = True
        for comp, want in zip(frame.components, coeffs):
            rows, cols = (-(-n // 8) for n in frame.size(comp))
            same &= bool(np.array_equal(comp.blocks[:rows, :cols], want[:rows, :cols])
                         and (np.array_equal(comp.blocks, want) if interleaved
                              else comp.blocks.sum() == comp.blocks[:rows, :cols].sum()))
        t0 = time.perf_counter()
        pixels = jpeg.pixels(frame)
        pixels_s = time.perf_counter() - t0
        err = float(np.abs(pixels - np.clip(jpeg_float_reference(coeffs, quant, h, w), 0,
                                            255)).max())
        out[name] = dict(bytes=len(buf), coefficients_equal=same, max_abs_err=err,
                         entropy_s=entropy_s, pixels_s=pixels_s,
                         ok=same and err <= JPEG_FLOAT_TOL)
    return out


def phase_real_disk_reference(torch, device, seed, tmp):
    """The script's JPEG writer against the port's decoder (`_jpeg_reference`),
    then each real-capture layout at REAL_REFERENCE_SIZES: the loader serving
    the card gives the CPU loader's first three batches bit for bit, and one
    cache step at NGP_NARROW's widths (the scene's SLF narrowed) runs GPU
    against CPU (`_gpu_vs_cpu_step`: every loss term, every gradient leaf,
    the CPU noise floor, two faults planted in the leveled kernel, every
    launch held against its plain version)."""
    import concurrent.futures
    import os

    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.engine import configs, gin_config

    checks = _jpeg_reference(seed)
    ok = all(c["ok"] for c in checks.values())
    print("real disk reference: the script's JPEG writer (4:2:0, Annex K tables) against the "
          "port's decoder: " + "; ".join(
              f"{name} {JPEG_CHECKS[name][0]}x{JPEG_CHECKS[name][1]} ({c['bytes']} bytes): "
              f"coefficients equal={c['coefficients_equal']}, pixels max_abs_err="
              f"{c['max_abs_err']:.3f} against the float reconstruction (tol {JPEG_FLOAT_TOL}), "
              f"entropy decode {c['entropy_s']:.4f}s, IDCT + upsampling + colour "
              f"{c['pixels_s']:.4f}s" for name, c in checks.items())
          + f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the port's JPEG decoder disagrees with the script's writer")

    out = {"jpeg": checks}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for scene, config_file in REAL_SCENES.items():
            data_dir, _, _ = write_real_scene(torch, device, scene,
                                              os.path.join(tmp, "real_reference", scene),
                                              REAL_REFERENCE_SIZES[scene], pool)
            data = _disk_bindings(scene, data_dir)
            narrow = NGP_NARROW + (_narrow_slf_binding(config_file),)
            gin_config.clear_config()
            configs.load_config(config_files=[config_file],
                                bindings=list(TRAINER_BINDINGS + narrow + data))
            config = configs.Config()
            gin_config.clear_config()
            loaded = [datasets.load_dataset("train", data_dir, config, device=dev)
                      for dev in ("cpu", device)]
            same = True
            for _ in range(3):
                want, got = (ds.next_train() for ds in loaded)
                same &= _same_batch(torch, got, want)
            served = (type(loaded[0]).__name__, tuple(loaded[0].images.shape))
            masked = loaded[0].masks is not None
            del loaded
            r = _gpu_vs_cpu_step(torch, device, seed, TRAINER_CACHE_STAGE + narrow + data,
                                 config_file, launches={"leveled": REAL_REFERENCE_LAUNCHES},
                                 terms=("data", "cache_data") + (("mask",) if masked else ()),
                                 tol=REAL_REFERENCE_GRAD_TOL.get(scene, GRAD_REL_L2_TOL))
            ok = r["ok"] and same
            print(f"real disk reference ({scene}): {served[0]} loader on {config_file}'s layout "
                  f"(images {list(served[1])}, JPEG), the card's first three batches equal to "
                  f"the CPU loader's={same}; the cache stage at reference widths (batch 64, 16 "
                  f"samples per level), one step, the same weights, batch and draws, gpu vs cpu: "
                  f"{_gpu_vs_cpu_text(r)}; the leveled calls against their plain version: "
                  f"{_checked_text(r['checked'])}; kernel launches gpu={r['launches']} "
                  f"cpu={r['cpu_launches']} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"the {scene} scene's GPU step or batches disagree with "
                                     "the CPU's")
            out[scene] = {k: v for k, v in r.items()
                          if k not in ("ok", "checked", "cpu_launches", "grad_rel_l2_errs")}
    return out


def _open_material_launches(batch, trainer):
    """open's table-gradient launches per step of its material stage at
    `batch`: the SLF's own grid and its reflectance grid (8 points per
    query, planes from PLANES_MIN_POINTS) for its queries along the
    secondary rays (batch x the stage's secondary samples), at the surface
    points (one per ray) and at the primary rays' final samples."""
    from neural_radiance_caching_tpu_torch.ops import hashgrid

    counts = {"leveled": 0, "planes": 0}
    for points in (batch * trainer.num_secondary_samples, batch, batch * NGP_FINAL_SAMPLES):
        for p in (points, points * SLF_DISTANCE_SAMPLES):
            counts["planes" if hashgrid.use_planes_layout(p, "mean") else "leveled"] += 1
    return {k: n for k, n in counts.items() if n}


# Phase 38's runs, as `_disk_entry_runs` takes them: open_egg's cache stage,
# then the README's second stage warm-started from it (its eval chunk
# 1024), each reading the test split at factor 8; the cache stages of
# neilf_castel and glossy_bear, 3 timed steps each.
REAL_RUNS = (
    ("open_egg", ("--scene", "obj_02_egg", "-t", "cache"), (8192, 4096, 2048), None,
     _open_launches, None, ("Config.test_factor = 8",)),
    ("open_egg", ("--scene", "obj_02_egg", "-t", "material_light_from_scratch_resample",
                  "--sample_factor", "8", "--render_chunk_size", "1024"), (1024, 512, 256),
     "open_egg_cache", _open_material_launches, None, ("Config.test_factor = 8",)),
    ("neilf_castel", ("--scene", "castel", "-t", "cache"), (8192, 4096, 2048), None,
     _open_launches, 3, ()),
    ("glossy_bear", ("-c", "glossy_ngp_yobo", "-t", "cache"), (8192, 4096, 2048), None,
     _open_launches, 3, ()),
)


def phase_real_disk_train(torch, device, seed, steps, smi, tmp):
    """Each real-capture layout written at REAL_SIZES (the writing's seconds
    and size), then REAL_RUNS through the train_with_trainer entry point
    (`_disk_entry_runs`)."""
    import concurrent.futures
    import os

    written = {}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for scene, sizes in REAL_SIZES.items():
            t0 = time.perf_counter()
            data_dir, nbytes, files = write_real_scene(torch, device, scene,
                                                       os.path.join(tmp, "real", scene), sizes,
                                                       pool)
            n, n_test, h, w = sizes
            views = (f"{n} train + {n_test} test views" if n_test else f"{n} views") + \
                f" of {w}x{h} JPEG"
            written[scene] = dict(data_dir=data_dir, write_s=time.perf_counter() - t0,
                                  gib=nbytes / 2**30, files=files, views=views)
            print(f"real disk train: wrote {scene} ({REAL_SCENES[scene]}'s layout, {views} "
                  f"(4:2:0, quality 95), rendered on the card): {files} files, "
                  f"{nbytes / 2**30:.3f} GiB in {written[scene]['write_s']:.1f}s", flush=True)
    results = _disk_entry_runs(torch, device, "real disk train", REAL_RUNS, written, seed,
                               steps, smi, tmp)
    return {"written": written, **results}


# Phase 39: evaluation as the JAX package computes it. hotdog's test view
# at its capture's size (TensoIR: 800^2 RGBA PNG) in phase 34's blender
# layout, beside the 2 train views the loader also reads; the LPIPS pair is
# that view, read back by the port's loader, and the spheres rendered 3%
# larger from its camera.
EVAL_HOTDOG_SIZES = (2, 1, 800)
EVAL_PRED_SCALE = 1.03
# LPIPS and E-LPIPS on the card against the CPU's on the same pair, in
# relative error: float32 convolutions summed in another order (cuDNN's
# TF32 off); the CPU's is ~1e-6 relative from the JAX package's.
LPIPS_REL_TOL = 1e-4
ELPIPS_SAMPLES = 2
# The probe at reference widths (NGP_NARROW, phase 33's 64^2 hotdog), GPU
# against CPU, per output in relative L2. The limit sits between the CPU
# noise floor (the probe's distance moved one ulp: 9.8e-3 at normals on a
# CPU, the density normals of untrained weights; the GPU's
# float32 differs in every layer, not in one input) and the two planted
# encoder faults (1.23 and 1.44 there).
PROBE_REL_L2_TOL = 0.2
# The profiled run: open_egg's cache stage at full width on SyntheticSpheres
# (phase 32's bindings), batch 8192, 1 leveled + 1 planes launch per step;
# (the first traced step, the traced steps).
PROFILE_STEPS = (4, 5)
PROFILE_BATCH = 8192
# A sun-and-sky env map written as a FLOAT EXR and read as the
# glossy-synthetic relight branch reads its own (downsample 4, y up,
# turned); the samplers' draws at 4096 points x 32 secondary rays.
ENV_MAP_SIZE = (256, 512)
SAMPLER_POINTS, SAMPLER_RAYS = 4096, 32
# The samplers' pdfs, card against CPU on the same texels: float32 rounding
# of a square root and a division (7.5e-9 absolute at pdfs ~0.06 on an
# H100).
SAMPLER_PDF_RTOL = 1e-6


def _sphere_normals(torch, points, alpha, scale):
    """The outward normal at each hit point of the procedural spheres
    (scaled by `scale`); +z where nothing is hit."""
    from neural_radiance_caching_tpu_torch.data import datasets

    normals = torch.zeros_like(points)
    normals[:, 2] = 1.0
    best = torch.full(points.shape[:1], float("inf"), device=points.device)
    for center, radius, _ in datasets.SyntheticSpheres.SPHERES:
        center = torch.tensor(center, device=points.device) * scale
        off = ((points - center).norm(dim=-1) - radius * scale).abs()
        closer = alpha & (off < best)
        normals = torch.where(closer[:, None], (points - center) / (radius * scale), normals)
        best = torch.where(closer, off, best)
    return normals


def _probe_inputs(torch, trainer, scale):
    """(the test view's rays, the median distance [H, W] and normals
    [H, W, 3] of the spheres hit along them) for the probe."""
    view = trainer.test_dataset.generate_ray_batch(0)
    rays = view.rays
    h, w = trainer.test_dataset.height, trainer.test_dataset.width
    _, alpha, best, points = _trace_spheres(torch, rays.origins.device, rays.origins,
                                            rays.viewdirs, scale)
    distance = torch.where(alpha, best, torch.full_like(best, 6.0))
    normals = _sphere_normals(torch, points, alpha, scale)
    return (rays, distance.reshape(h, w).cpu().numpy(),
            normals.reshape(h, w, 3).cpu().numpy())


def _eval_lpips(torch, device, seed, smi, data_dir):
    """The metric harness and E-LPIPS on hotdog's test view on the card
    against the CPU, the ms of one LPIPS pair and its peak memory."""
    import numpy as np

    from neural_radiance_caching_tpu_torch.data import camera_utils, datasets
    from neural_radiance_caching_tpu_torch.engine import configs, gin_config
    from neural_radiance_caching_tpu_torch.ops import image, lpips
    from neural_radiance_caching_tpu_torch.utils import vis, weights

    radius, scale = DISK_CAMERAS["hotdog"]
    gin_config.clear_config()
    configs.load_config(config_files=[DISK_SCENES["hotdog"]],
                        bindings=list(TRAINER_BINDINGS + _disk_bindings("hotdog", data_dir)))
    config = configs.Config()
    gin_config.clear_config()
    test = datasets.load_dataset("test", data_dir, config, device=device)
    gt = np.clip(vis.linear_to_srgb(test.images[0]), 0.0, 1.0).astype(np.float32)
    size = test.width
    focal = 0.5 * size / np.tan(0.5 * BLENDER_CAMERA_ANGLE_X)
    pose = camera_utils.generate_spherical_poses(1, radius=radius, seed=52)
    pred, _, _ = next(_render_spheres(torch, device, pose,
                                      camera_utils.get_pixtocam(focal, size, size), size,
                                      scale * EVAL_PRED_SCALE))
    pred = pred.astype(np.float32)
    t0 = time.perf_counter()
    got = image.MetricHarness(device=device)(pred, gt)
    harness_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = image.MetricHarness(device="cpu")(pred, gt)
    cpu_s = time.perf_counter() - t0
    lpips_err = abs(got["lpips"] - want["lpips"]) / want["lpips"]
    params = weights.lpips_params_to_torch(lpips.default_params(), device)
    pred_t, gt_t = (torch.as_tensor(a, device=device) for a in (pred, gt))
    ms = _cuda_ms(lambda: lpips.lpips(params, pred_t, gt_t), repeats=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    lpips.lpips(params, pred_t, gt_t)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    added_gib = (torch.cuda.max_memory_allocated() - before) / 2**30
    e_gpu = lpips.elpips(params, pred, gt, num_samples=ELPIPS_SAMPLES, seed=seed,
                         dropout_keep=1.0, device=device)
    e_cpu = lpips.elpips(lpips.default_params(), pred, gt, num_samples=ELPIPS_SAMPLES, seed=seed,
                         dropout_keep=1.0, device="cpu")
    elpips_err = abs(e_gpu - e_cpu) / e_cpu
    ok = (lpips_err <= LPIPS_REL_TOL and elpips_err <= LPIPS_REL_TOL and _lpips_ok(got)
          and got["lpips_calibrated"] == 0.0 and got["lpips"] > 0
          and abs(got["psnr"] - want["psnr"]) <= 1e-4)
    print(f"eval extras (lpips): hotdog's {size}^2 test view in the blender layout read by the "
          f"port's loader against the spheres rendered {EVAL_PRED_SCALE}x larger from its "
          f"camera: the metric harness on the card psnr={got['psnr']:.4f} ssim={got['ssim']:.4f} "
          f"{_lpips_text(got)} ({harness_s:.2f}s, the uncalibrated VGG-16 built and moved "
          f"included), on the CPU lpips={want['lpips']:.6f} ({cpu_s:.2f}s): rel err "
          f"{lpips_err:.3e} (tol {LPIPS_REL_TOL}); one {size}^2 LPIPS pair {ms:.3f} ms (median "
          f"of 5 by CUDA events, TF32 off), peak {peak_gib:.3f} GiB allocated ({added_gib:.3f} "
          f"GiB over the inputs and weights); E-LPIPS ({ELPIPS_SAMPLES} samples, seed {seed}, "
          f"dropout_keep=1.0) {e_gpu:.6f} on the card, {e_cpu:.6f} on the CPU: rel err "
          f"{elpips_err:.3e} on [{smi}] {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("LPIPS on the card disagrees with the CPU's")
    return dict(view=f"{size}x{size}", lpips=got["lpips"], lpips_cpu=want["lpips"],
                rel_err=lpips_err, tol=LPIPS_REL_TOL, ms_per_pair=ms, peak_gib=peak_gib,
                added_gib=added_gib, harness_s=harness_s, cpu_s=cpu_s, elpips=e_gpu,
                elpips_cpu=e_cpu, elpips_rel_err=elpips_err, avg_err=got["avg_err"],
                psnr=got["psnr"], ssim=got["ssim"])


def _eval_probe_reference(torch, device, seed, ref_dir):
    """The secondary-ray probe of hotdog's material stage at reference
    widths, GPU against CPU, with its noise floor and two planted faults."""
    import numpy as np

    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    _, scale = DISK_CAMERAS["hotdog"]
    # hotdog's near plane (2) is its secondary_far too, which leaves the
    # probe's rays no interval to sample; the probe here reaches its far
    # plane, 6, so that its rays cross the scene.
    bindings = NGP_NARROW + _disk_bindings("hotdog", ref_dir) + (
        "Trainer.stage = 'material_light_from_scratch'", "Config.render_chunk_size = 2048",
        "Config.secondary_far = 6.0")
    gpu = _trainer_setup(torch, device, DISK_SCENES["hotdog"], bindings)
    cpu = _trainer_setup(torch, "cpu", DISK_SCENES["hotdog"], bindings)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    h, w = cpu.test_dataset.height, cpu.test_dataset.width
    sx, sy = int(np.round(w * 0.3)), int(np.round(h * 0.6))
    # One set of host inputs for both devices.
    rays, distance_in, normals = _probe_inputs(torch, cpu, scale)

    def probe(trainer, nudge=False, fault=None):
        distance = distance_in
        if nudge:
            distance = distance.copy()
            distance[sy, sx] = np.nextafter(distance[sy, sx], np.float32(np.inf))
        trainer.render_rng = torch.Generator().manual_seed(seed + 39)
        trainer._render_secondary_fn = None
        patch = dict(multires_grid_encode=_planted_encoder_fault(fault)) if fault else {}
        with _patched(hashgrid, **patch):
            return trainer.render_secondary_rays(rays, distance, normals, sx, sy, 1.0)

    before = dict(scatter_cuda.launches)
    ref = probe(cpu)
    floor, floor_at = _worst_output_err(probe(cpu, nudge=True), ref)
    images = probe(gpu)
    err, err_at = _worst_output_err(images, ref)
    faults = {f: _worst_output_err(probe(gpu, fault=f), ref)
              for f in ("finest level dropped", "levels reversed")}
    launched = {k: scatter_cuda.launches[k] - before[k] for k in before}
    tol = PROBE_REL_L2_TOL
    ok = (sorted(images) == sorted(ref) and floor <= tol and err <= tol
          and all(v > tol for v, _ in faults.values()) and launched == _launch_counts()
          and all(bool(np.isfinite(v).all()) for v in images.values())
          and images["rgb"].shape == (*gpu._probe_resolution(), 3))
    print(f"eval extras (probe reference): Trainer.render_secondary_rays of hotdog's "
          f"material_light_from_scratch stage at reference widths on its {h}^2 test view, the "
          f"pixel ({sx}, {sy}) at the spheres' distance and normal, {images['rgb'].shape[0]}x"
          f"{images['rgb'].shape[1]} probe rays (passes cache, light, is_secondary), the same "
          f"weights and draws, gpu vs cpu over {len(ref)} outputs: rel_l2_err max={err:.3e} at "
          f"{err_at} (tol {tol}; noise floor, cpu vs cpu with the pixel's distance +1 ulp: "
          f"{floor:.3e} at {floor_at}; planted in the gpu encoder forward "
          + ", ".join(f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
          + f", each must exceed the tol) scatter launches={launched} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the GPU probe disagrees with the CPU's")
    return dict(outputs=len(ref), rel_l2_err=err, at=err_at, floor=floor, floor_at=floor_at,
                tol=tol, faults={f: v for f, (v, _) in faults.items()})


def _eval_profile(torch, device, seed, tmp):
    """A Config.profile_dir trace of open_egg's cache stage through the
    entry point: its file, CUDA kernel events, the table-gradient kernels'
    launches and the steps' labels."""
    import os

    from neural_radiance_caching_tpu_torch import train_with_trainer
    from neural_radiance_caching_tpu_torch.engine import gin_config
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    config_file, extra = BASELINE_SCENES["open_egg"]
    first, count = PROFILE_STEPS
    ckpt = os.path.join(tmp, "profile_open_egg")
    trace_dir = os.path.join(tmp, "profile_trace")
    args = [f"--gin_configs={config_file}", "--device", device] + [
        f"--gin_bindings={b}" for b in TRAINER_BINDINGS + TRAINER_CACHE_STAGE + tuple(extra) + (
            f"Config.batch_size = {PROFILE_BATCH}", f"Config.checkpoint_dir = '{ckpt}'",
            f"Config.early_exit_steps = {first + count}",
            f"Config.print_every = {first + count}", f"Config.jax_rng_seed = {20200823 + seed}",
            f"Config.profile_dir = '{trace_dir}'", f"Config.profile_start_step = {first}",
            f"Config.profile_num_steps = {count}")]
    gin_config.clear_config()
    scatter_cuda.reset_launch_count()
    t0 = time.perf_counter()
    trainer = train_with_trainer.main(args)
    run_s = time.perf_counter() - t0
    launches = dict(scatter_cuda.launches)
    per_step = _open_launches(PROFILE_BATCH)
    del trainer
    gin_config.clear_config()
    traces = sorted(os.listdir(trace_dir))
    path = os.path.join(trace_dir, traces[0])
    trace_mb = os.path.getsize(path) / 1e6
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    scatters = [e for e in kernels if "scatter_add_kernel" in e.get("name", "")]
    # Each step's label, on the host's timeline (and, on the card, again on
    # the device's).
    labels = [e for e in events if str(e.get("name", "")).startswith("train step_num=")]
    steps = sorted({e["name"] for e in labels})
    busy = float("nan")
    if kernels:
        span = (max(e["ts"] + e.get("dur", 0) for e in kernels) - min(e["ts"] for e in kernels))
        busy = sum(e.get("dur", 0) for e in kernels) / max(span, 1e-9)
    ok = (traces == [f"train_steps_{first}-{first + count - 1}.json"] and len(kernels) > 0
          and len(scatters) == count * sum(per_step.values())
          and steps == sorted(f"train step_num={s}" for s in range(first, first + count))
          and launches == _launch_counts(**{k: n * (first + count)
                                            for k, n in per_step.items()}))
    print(f"eval extras (profile): train_with_trainer {config_file} cache stage at full width "
          f"(batch {PROFILE_BATCH} on SyntheticSpheres, Config.far 4) with Config.profile_dir, "
          f"steps {first}-{first + count - 1} of {first + count} traced: {traces} "
          f"({trace_mb:.1f} MB Chrome trace), {len(kernels)} CUDA kernel events, "
          f"{len(scatters)} of them the table-gradient kernel (expected {count} x {per_step}), "
          f"{len(steps)} steps labelled 'train step_num=N' ({len(labels)} labels on the host's "
          f"and the device's timelines); kernels busy {100 * busy:.1f}% of "
          f"the traced kernels' span; launches over the run {launches}; {run_s:.1f}s "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the profile_dir trace lacks the card's kernels or the steps")
    return dict(config=config_file, traced_steps=count, trace_mb=trace_mb,
                kernel_events=len(kernels), scatter_events=len(scatters),
                kernel_busy_share=busy, run_s=run_s, launches=launches)


def _eval_samplers(torch, device, seed, tmp):
    """The environment and quadrature samplers over an EXR env map on the
    card against the CPU, on the same draws."""
    import os

    import numpy as np

    from neural_radiance_caching_tpu_torch.data import env_maps, exr
    from neural_radiance_caching_tpu_torch.ops import render_utils

    rng = np.random.RandomState(seed)
    eh, ew = ENV_MAP_SIZE
    yy, xx = np.meshgrid(np.linspace(0, 1, eh), np.linspace(0, 1, ew), indexing="ij")
    sun = np.exp(-((yy - 0.3) ** 2 + (xx - 0.6) ** 2) / 2e-3)[..., None]
    env = (0.3 * (1 - yy)[..., None] * np.array([0.5, 0.7, 1.0]) + 40 * sun
           + rng.uniform(0, 0.05, (eh, ew, 3))).astype(np.float32)
    env_path = os.path.join(tmp, "eval_env.exr")
    exr.write_exr(env_path, env)
    tables = env_maps.load_env_map(env_path, downsample=4, y_up=True, flip=True)
    gen = torch.Generator().manual_seed(seed + 7)
    u1 = torch.rand((SAMPLER_POINTS, SAMPLER_RAYS), generator=gen)
    wo = torch.nn.functional.normalize(torch.randn((SAMPLER_POINTS, SAMPLER_RAYS, 3),
                                                   generator=gen), dim=-1)
    light_idx = torch.zeros((SAMPLER_POINTS, 1), dtype=torch.int32)

    def kwargs(dev):
        return {k: torch.as_tensor(tables[k], device=dev)
                for k in ("env_map", "env_map_pmf", "env_map_pdf", "env_map_dirs")}

    samplers = {}
    for name, sampler in (("environment", render_utils.EnvironmentSampler()),
                          ("quadrature", render_utils.QuadratureEnvmapSampler())):
        outs = {dev: [o.cpu() for o in sampler.sample_directions(
            torch.Generator().manual_seed(seed + 8), u1.to(dev), u1.to(dev), wo.to(dev), None,
            light_idx.to(dev), kwargs(dev))] for dev in ("cpu", device)}
        # The same texels (directions and radiance gathered exactly), their
        # pdfs to float32 rounding (a sqrt and a division on each device).
        (dirs, pdf, rgb), (cpu_dirs, cpu_pdf, cpu_rgb) = outs[device], outs["cpu"]
        same = (dirs == cpu_dirs).all(-1) & (rgb == cpu_rgb).all(-1)
        samplers[name] = dict(
            same_share=float(same.float().mean()),
            max_abs_err=max(float((g - c).abs().max()) for g, c in zip(outs[device], outs["cpu"])),
            pdf_rel_err=float(((pdf - cpu_pdf).abs() / cpu_pdf.abs().clamp(min=1e-30))[same].max()),
            finite=all(bool(torch.isfinite(o).all()) for o in outs[device]),
            mean_pdf=float(pdf.mean()))
    # The quadrature over every texel of the z-up tables (its pdf's polar
    # axis): the mean of 1/pdf is the sphere's 4 pi.
    z_up = env_maps.build_env_map_tables(env)
    texels = z_up["env_map_h"] * z_up["env_map_w"]
    _, pdf, _ = render_utils.QuadratureEnvmapSampler().sample_directions(
        None, torch.zeros((1, texels), device=device), None, None, None, None,
        {k: torch.as_tensor(z_up[k], device=device) for k in ("env_map", "env_map_dirs")})
    integral = float((1.0 / pdf).mean())
    ok = (all(r["finite"] and r["same_share"] >= 0.99 and r["pdf_rel_err"] <= SAMPLER_PDF_RTOL
              for r in samplers.values())
          and samplers["quadrature"]["same_share"] == 1.0
          and abs(integral - 4 * np.pi) / (4 * np.pi) < 0.02)
    print(f"eval extras (samplers): a {eh}x{ew} sun-and-sky env map written as a FLOAT EXR, "
          f"read as the glossy relight branch reads its own (downsample 4, y up, turned: "
          f"{tables['env_map_h']}x{tables['env_map_w']} texels), {SAMPLER_POINTS} points x "
          f"{SAMPLER_RAYS} secondary rays, the same draws on both devices, gpu vs cpu: "
          + "; ".join(f"{n} {100 * r['same_share']:.2f}% of the samples on the same texel, "
                      f"their pdfs within {r['pdf_rel_err']:.3e} relative (tol "
                      f"{SAMPLER_PDF_RTOL}), max abs err {r['max_abs_err']:.3e}, mean pdf "
                      f"{r['mean_pdf']:.4f}"
                      for n, r in samplers.items())
          + f"; the quadrature over every texel of the map, z up: mean 1/pdf {integral:.4f} "
          f"(4 pi = {4 * np.pi:.4f}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the env samplers on the card disagree with the CPU's")
    return dict(samplers, quadrature_integral=integral)


def phase_eval_extras(torch, device, seed, smi, tmp):
    """Phase 39: hotdog's 800^2 test view (and phase 33's 64^2 one) written
    in the blender layout, then `_eval_lpips`, `_eval_probe_reference`,
    `_eval_profile` and `_eval_samplers`."""
    import concurrent.futures
    import os

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        data_dir, _, _ = write_disk_scene(torch, device, "hotdog",
                                          os.path.join(tmp, "eval_hotdog"), EVAL_HOTDOG_SIZES,
                                          pool)
        ref_dir, _, _ = write_disk_scene(torch, device, "hotdog",
                                         os.path.join(tmp, "eval_reference_hotdog"),
                                         DISK_REFERENCE_SIZES["hotdog"], pool)
    return {"lpips": _eval_lpips(torch, device, seed, smi, data_dir),
            "probe_reference": _eval_probe_reference(torch, device, seed, ref_dir),
            "profile": _eval_profile(torch, device, seed, tmp),
            "samplers": _eval_samplers(torch, device, seed, tmp)}


# Phase 40: data-parallel training (parallel/mesh.py). Two gloo ranks share
# the one card, each with half of the flagship cache step's 8192 rays and
# half of the material step's 1536, each on its own kernel route: a rank's
# 768 x 32 x 32 = 786,432 secondary samples fall under PLANES_MIN_POINTS
# (2^20), so the material step takes 3 leveled scatters per rank where one
# process takes 2 leveled + 1 planes. Then a one-rank NCCL world through
# torchrun and the entry point.
DP_WORLD = 2
DP_WARMUP = 2
DP_STEPS = 3
DP_STAGES = ("cache", "material")
DP_LAUNCHES_PER_STEP = {"cache": {"leveled": 1}, "material": {"leveled": 3}}
DP_LOSS_TOL = {"cache": 1e-4, "material": 1e-3}
# The all-reduced gradient leaves against one process's, in relative L2.
# Both steps run on the card at full width, so the bracket is read there:
# the noise floor is one process against itself with the ray origins one
# ulp up (9.2e-2 on the cache, 1.4e-1 on the material, H100 80GB HBM3,
# 700 W), the planted fault (rank 1 keeping its own gradient) reads ~1.
# Each run also holds the ranks under that run's floor: the sharded step
# moves the gradient less than a one-ulp change of the rays does (bf16
# GEMMs of half the rows round differently; the sums over rays are
# reassociated).
DP_GRAD_TOL = {"cache": 0.2, "material": 0.2}
DP_TIMEOUT_S = 600.0
DP_TRAINER_STEPS = 4


def _dp_model(torch, stage, device, seed):
    """(config, model, train state, train step) of the full-width flagship
    `stage` on `device`, initialised from `seed`."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.parallel import train

    if stage == "cache":
        config, build = flagship.cache_config(), flagship.build_flagship_cache_model
    else:
        config, build = flagship.material_config(), flagship.build_flagship_material_model
    torch.manual_seed(seed)
    model = build(config, device=device)
    state, _ = train.create_optimizer(config, model)
    return config, model, state, train.create_train_step(model, config)


def _dp_batches(stage, n):
    """`n` global batches of `stage` on the host (SyntheticSpheres, 8 views
    at 128^2)."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets

    config = flagship.cache_config() if stage == "cache" else flagship.material_config()
    data = datasets.SyntheticSpheres("train", None, config, num_images=8, resolution=128,
                                     device="cpu")
    return [data.next_train() for _ in range(n)]


def _dp_rng(torch, device, seed):
    return torch.Generator(device=device).manual_seed(seed + 44)


def _dp_losses(torch, stats):
    """The step's loss and loss terms, averaged over the ranks."""
    from neural_radiance_caching_tpu_torch.parallel import mesh as mesh_lib

    names, device = sorted(stats["losses"]), stats["loss"].device
    values = torch.stack([stats["loss"].detach().float().reshape(())] + [
        torch.as_tensor(stats["losses"][k], device=device).detach().float().reshape(())
        for k in names])
    return dict(zip(["loss"] + names, mesh_lib.allreduce_mean(values).tolist()))


def _dp_hashes(model):
    """A SHA-256 of each parameter's and buffer's bytes."""
    import hashlib

    import torch

    return {k: hashlib.sha256(v.detach().reshape(-1).contiguous().cpu().view(torch.uint8)
                              .numpy().tobytes()).hexdigest()
            for k, v in model.state_dict().items()}


def _dp_keeping_own_gradient(allreduce):
    """The planted fault: rank 1 takes part in the all-reduce but keeps its
    own gradient."""
    from neural_radiance_caching_tpu_torch.parallel import mesh as mesh_lib

    def faulty(params):
        own = [p.grad.clone() for p in params]
        allreduce(params)
        if mesh_lib.process_index() == 1:
            for p, g in zip(params, own):
                p.grad.copy_(g)

    return faulty


def _dp_rank(mesh, batches, seed, steps, warmup):
    """One rank of phase 40 (run by parallel/mesh.spawn): for each stage, one
    step with the planted fault, then one step with every scatter held
    against its plain version, then `warmup` + `steps` timed steps with the
    all-reduce timed by CUDA events and the launches counted."""
    import statistics

    import torch

    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scatter_cuda.load_library()
    device, out = mesh.device, {}
    for stage in DP_STAGES:
        shards = [mesh_lib.shard_batch(b).to(device) for b in batches[stage]]
        _, model, state, step = _dp_model(torch, stage, device, seed)
        mesh_lib.replicate(model, state.optimizer)
        with _patched(mesh_lib, allreduce_gradients=_dp_keeping_own_gradient(
                mesh_lib.allreduce_gradients)):
            state, _ = step(_dp_rng(torch, device, seed), state, shards[0], 0.5)
        fault = ({k: p.grad.detach().cpu() for k, p in model.named_parameters()}
                 if mesh.rank == 1 else None)
        fault_hashes = _dp_hashes(model)
        del model, state, step
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        _, model, state, step = _dp_model(torch, stage, device, seed)
        mesh_lib.replicate(model, state.optimizer)
        rng = _dp_rng(torch, device, seed)
        calls = []
        with _patched(scatter_cuda,
                      scatter_add_weighted_leveled=_checking_scatter("leveled", calls),
                      scatter_add_weighted_planes=_checking_scatter("planes", calls)):
            state, stats = step(rng, state, shards[0], 0.5)
        losses = _dp_losses(torch, stats)
        grads = ({k: p.grad.detach().cpu() for k, p in model.named_parameters()}
                 if mesh.rank == 0 else None)

        events, real = [], mesh_lib.allreduce_gradients

        def timed(params):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            real(params)
            end.record()
            events.append((start, end))

        step_losses = []
        with _patched(mesh_lib, allreduce_gradients=timed):
            scatter_cuda.reset_launch_count()
            for i in range(warmup + steps):
                if i == warmup:
                    torch.cuda.synchronize()
                    mesh_lib.barrier()
                    t0 = time.perf_counter()
                state, stats = step(rng, state, shards[(1 + i) % len(shards)], 0.5)
                step_losses.append(stats["loss"])
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / steps
            launches = dict(scatter_cuda.launches)
        out[stage] = dict(
            losses=losses, grads=grads, fault=fault, fault_hashes=fault_hashes, calls=calls,
            hashes=_dp_hashes(model), step_ms=dt * 1e3, rows=int(shards[0].rgb.shape[0]),
            allreduce_ms=statistics.median(s.elapsed_time(e) for s, e in events[warmup:]),
            allreduce_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
            finite=_finite(float(v) for v in step_losses))
        del model, state, step, shards
        torch.cuda.empty_cache()
    return out


def _dp_reference(torch, device, seed, stage, batches, warmup, steps):
    """One process on the global batch: the first step's losses and
    gradients, the noise floor (the same step with the ray origins one ulp
    up), and `warmup` + `steps` timed steps."""
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    def first_step(batch):
        _, model, state, step = _dp_model(torch, stage, device, seed)
        _, stats = step(_dp_rng(torch, device, seed), state, batch, 0.5)
        grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        return {k: float(torch.as_tensor(v).detach()) for k, v in
                {"loss": stats["loss"], **stats["losses"]}.items()}, grads

    batch = batches[0].to(device)
    origins = batch.rays.origins
    nudged = batch.replace(rays=batch.rays.replace(
        origins=torch.nextafter(origins, torch.full_like(origins, float("inf")))))
    losses, grads = first_step(batch)
    floor, floor_at = _worst_grad_err(first_step(nudged)[1], grads)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, model, state, step = _dp_model(torch, stage, device, seed)
    rng = _dp_rng(torch, device, seed)
    on_card = [b.to(device) for b in batches]
    scatter_cuda.reset_launch_count()
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, _ = step(rng, state, on_card[(1 + i) % len(on_card)], 0.5)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    out = dict(losses=losses, grads=grads, floor=floor, floor_at=floor_at, step_ms=dt * 1e3,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=dict(scatter_cuda.launches))
    del model, state, step, on_card
    torch.cuda.empty_cache()
    return out


def _dp_trainer_nccl(torch, seed, smi, tmp, steps):
    """train_with_trainer on the full-width ngp_yobo.gin cache stage under
    torchrun (one process: a one-rank NCCL world on the card) into `tmp`."""
    import json
    import os

    from neural_radiance_caching_tpu_torch.utils import checkpoints

    ckpt = os.path.join(tmp, "dp_nccl_cache")
    bindings = TRAINER_BINDINGS + TRAINER_CACHE_STAGE + (
        f"Config.checkpoint_dir = '{ckpt}'", f"Config.early_exit_steps = {steps}",
        "Config.print_every = 2", f"Config.jax_rng_seed = {20200823 + seed}")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "-m", "neural_radiance_caching_tpu_torch.train_with_trainer",
           f"--gin_configs={TRAINER_CONFIG}"] + [f"--gin_bindings={b}" for b in bindings]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    group_line = "data-parallel group: 1 rank(s), nccl, rank 0 on cuda:0"
    log_path = os.path.join(ckpt, "train_log.jsonl")
    log = ([json.loads(line) for line in open(log_path).read().splitlines()]
           if os.path.exists(log_path) else [])
    saved = checkpoints.latest_checkpoint_step(ckpt) if os.path.isdir(ckpt) else None
    ok = (proc.returncode == 0 and group_line in proc.stdout and saved == steps
          and [r["step"] for r in log] == [1] + list(range(2, steps + 1, 2))
          and _finite(r["loss"] for r in log))
    rays_per_s = log[-1]["rays_per_sec"] if log else float("nan")
    print(f"data parallel (nccl): torchrun --standalone --nproc_per_node 1 -m "
          f"neural_radiance_caching_tpu_torch.train_with_trainer {TRAINER_CONFIG} cache stage, "
          f"{steps} steps: exit {proc.returncode}, group line present={group_line in proc.stdout}"
          f", checkpoint step {saved}, train_log steps {[r['step'] for r in log]} rays_per_sec "
          f"{rays_per_s:.0f} on [{smi}], command {wall:.1f}s {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", flush=True)
        raise AssertionError("the one-rank NCCL world through the entry point failed")
    return dict(exit=proc.returncode, checkpoint_step=saved, steps=steps,
                rays_per_s=rays_per_s, command_s=wall)


def phase_data_parallel(torch, device, seed, smi, tmp):
    """Phase 40: two gloo ranks sharing the card against one process on the
    global batch, at full width, for the flagship cache and material steps;
    then a one-rank NCCL world through torchrun and the entry point."""
    import os

    from neural_radiance_caching_tpu_torch.parallel import mesh as mesh_lib

    batches = {stage: _dp_batches(stage, 4) for stage in DP_STAGES}
    reference = {stage: _dp_reference(torch, device, seed, stage, batches[stage], DP_WARMUP,
                                      DP_STEPS) for stage in DP_STAGES}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(
        "chip_smoke:_dp_rank", DP_WORLD,
        dict(batches=batches, seed=seed, steps=DP_STEPS, warmup=DP_WARMUP),
        workdir=os.path.join(tmp, "dp_ranks"), device="cuda:0", backend="gloo",
        timeout_s=DP_TIMEOUT_S, paths=[os.path.dirname(os.path.abspath(__file__))], threads=4)
    spawn_s = time.perf_counter() - t0
    out = {"spawn_s": spawn_s, "world": DP_WORLD, "backend": "gloo", "device": smi}
    failed = []
    for stage in DP_STAGES:
        ref, r0, r1 = reference[stage], ranks[0][stage], ranks[1][stage]
        global_rows = DP_WORLD * r0["rows"]
        loss_err = max(abs(r0["losses"][k] - v) / max(abs(v), 1e-12)
                       for k, v in ref["losses"].items())
        err, err_at = _worst_grad_err(r0["grads"], ref["grads"])
        fault, fault_at = _worst_grad_err(r1["fault"], ref["grads"])
        tol = DP_GRAD_TOL[stage]
        per_step = DP_LAUNCHES_PER_STEP[stage]
        calls_ok = all(
            {k: sum(c["kind"] == k for c in r[stage]["calls"]) for k in ("leveled", "planes")}
            == {"leveled": per_step["leveled"], "planes": 0}
            and all(c["ok"] for c in r[stage]["calls"]) for r in ranks)
        launches_ok = all(r[stage]["launches"] == _launch_counts(
            leveled=per_step["leveled"] * (DP_WARMUP + DP_STEPS)) for r in ranks)
        same = r0["hashes"] == r1["hashes"]
        fault_split = r0["fault_hashes"] != r1["fault_hashes"]
        ok = (r0["finite"] and r1["finite"] and loss_err <= DP_LOSS_TOL[stage]
              and ref["floor"] <= tol and err <= min(tol, ref["floor"]) and fault > tol
              and calls_ok
              and launches_ok and same and fault_split
              and sorted(r0["losses"]) == sorted(ref["losses"]))
        shared_rays = global_rows / (max(r0["step_ms"], r1["step_ms"]) / 1e3)
        one_rays = global_rows / (ref["step_ms"] / 1e3)
        print(f"data parallel ({stage}): {DP_WORLD} gloo ranks sharing the card, "
              f"{r0['rows']} of {global_rows} rays each, against one process on the global "
              f"batch: loss rel_err={loss_err:.3e} (tol {DP_LOSS_TOL[stage]}), all-reduced "
              f"grad rel_l2_err max={err:.3e} at {err_at} (tol {tol}, and under the noise "
              f"floor, one process with origins +1 ulp on the card: {ref['floor']:.3e} at "
              f"{ref['floor_at']}; "
              f"planted, rank 1 keeping its own gradient: {fault:.3e} at {fault_at}, must "
              f"exceed the tol); parameters bitwise equal across ranks after "
              f"{1 + DP_WARMUP + DP_STEPS} steps={same} (after the fault step: differ="
              f"{fault_split}); each rank's checked step: "
              + "; ".join(f"rank {i}: " + ", ".join(
                  f"{c['kind']} idx{list(c['shape'])} max_abs_err={c['max_abs_err']:.3e} "
                  f"{'ok' if c['ok'] else 'FAIL'}" for c in r[stage]["calls"])
                  for i, r in enumerate(ranks))
              + f"; {DP_WARMUP} warmup + {DP_STEPS} timed steps: step_ms rank 0 "
              f"{r0['step_ms']:.2f} rank 1 {r1['step_ms']:.2f} (one process "
              f"{ref['step_ms']:.2f}), rays_per_s {shared_rays:.1f} (one process "
              f"{one_rays:.1f}); all-reduce {r0['allreduce_bytes']} bytes per step, "
              f"{r0['allreduce_ms']:.2f} / {r1['allreduce_ms']:.2f} ms (median, CUDA events, "
              f"gloo through the host); peak GiB rank 0 {r0['peak_gib']:.2f} rank 1 "
              f"{r1['peak_gib']:.2f} (one process {ref['peak_gib']:.2f}); launches per rank "
              f"{[r[stage]['launches'] for r in ranks]} (expected {per_step} per step) on "
              f"[{smi}] {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append(stage)
        out[stage] = dict(
            rows_per_rank=r0["rows"], global_rows=global_rows, loss_rel_err=loss_err,
            grad_rel_l2_err=err, noise_floor=ref["floor"], planted_fault=fault,
            step_ms=[r0["step_ms"], r1["step_ms"]], one_process_step_ms=ref["step_ms"],
            rays_per_s=shared_rays, one_process_rays_per_s=one_rays,
            allreduce_ms=[r0["allreduce_ms"], r1["allreduce_ms"]],
            allreduce_bytes=r0["allreduce_bytes"], peak_gib=[r0["peak_gib"], r1["peak_gib"]],
            one_process_peak_gib=ref["peak_gib"],
            launches=[r[stage]["launches"]["leveled"] for r in ranks],
            max_abs_err=max(c["max_abs_err"] for r in ranks for c in r[stage]["calls"]))
    if failed:
        raise AssertionError(f"data-parallel ranks disagree with one process: {failed}")
    torch.cuda.empty_cache()
    out["nccl_trainer"] = _dp_trainer_nccl(torch, seed, smi, tmp, DP_TRAINER_STEPS)
    return out


# Phases 41-42: a capture posed by COLMAP in mip-NeRF 360's layout
# (`sparse/0/cameras.bin` with one OPENCV camera at the full resolution,
# `sparse/0/images.bin`, the views in `images_4/`), read by the llff
# loader, the default of Config.dataset_loader that ngp_yobo.gin keeps.
COLMAP_CONFIG = "configs/ngp_yobo.gin"
# (views, height, width) of images_4/: phase 42 at garden's factor-4 size
# (its 185 views cut to 16, 24 until phase 47 came, of which llffhold 8
# holds out 2; no full-resolution images/: the loader at factor 4 reads
# images_4/ only); phase 41 small.
COLMAP_SIZES = (16, 840, 1297)
COLMAP_REFERENCE_SIZES = (9, 96, 128)
COLMAP_FACTOR = 4
# mip-NeRF 360's OPENCV terms, and the focal over the full-resolution width.
COLMAP_DISTORTION = {"k1": -0.03, "k2": 0.01, "p1": 1e-4, "p2": -1e-4}
COLMAP_FOCAL = 0.9
# The cameras' radius before the loader's alignment and the spheres' scale
# in its frame (the principal-axis alignment puts the cameras inside
# [-1, 1]^3), and the near plane bound beside ngp_yobo.gin's far of 6.
COLMAP_CAMERAS = (4.0, 0.45)
COLMAP_NEAR = 0.2
# The in-step cast on the card against the loader's host cast (numpy,
# float64 after the float32 cameras; its Newton solve in float64): the
# largest absolute difference of any ray field. The card's float32 solve
# converges to its own rounding, ~1e-7 at the corner pixels' radii of
# ~0.7 in focal units.
COLMAP_CAST_TOL = 2e-6
COLMAP_BINDINGS = (f"Config.dataset_loader = 'llff'", f"Config.factor = {COLMAP_FACTOR}",
                   f"Config.near = {COLMAP_NEAR}")
# The flagship cache step (flagship.py, batch 8192) on the LLFF scene's
# batches, cast in the step: checked steps (every leveled call held
# against its plain version), then timed steps.
COLMAP_FLAGSHIP_CHECKED = 3
COLMAP_FLAGSHIP_TIMED = 5


def _colmap_config(data_dir, *extra):
    """ngp_yobo.gin's Config with the scene's bindings (over the trainer
    phases' data-free ones) and `extra`."""
    from neural_radiance_caching_tpu_torch.engine import configs, gin_config

    gin_config.clear_config()
    configs.load_config(config_files=[COLMAP_CONFIG], bindings=list(
        TRAINER_BINDINGS + COLMAP_BINDINGS + (f"Config.data_dir = '{data_dir}'",) + extra))
    config = configs.Config()
    gin_config.clear_config()
    return config


def _colmap_cast_errs(torch, device, dataset, batches):
    """The train step's caster on the card (`parallel/train._ray_caster`:
    the Newton solve in float32 on the card) against the loader's host
    cast of the same Pixels: the largest absolute difference per field."""
    import dataclasses
    import types

    import numpy as np

    from neural_radiance_caching_tpu_torch.data import camera_utils
    from neural_radiance_caching_tpu_torch.parallel import train
    from neural_radiance_caching_tpu_torch.utils import pytrees

    model = types.SimpleNamespace(parameters=lambda: iter([torch.zeros(1, device=device)]))
    cast = train._ray_caster(dataset.config, dataset, model)
    errs = {}
    for batch in batches:
        pixels = batch.rays
        got = cast(None, pixels)
        host = pytrees.Pixels(**{f.name: None if getattr(pixels, f.name) is None
                                 else getattr(pixels, f.name).cpu().numpy()
                                 for f in dataclasses.fields(pixels)})
        want = camera_utils.cast_ray_batch(dataset.cameras, dataset.lights, host)
        for f in ("origins", "directions", "viewdirs", "radii", "imageplane", "look", "up"):
            err = float(np.abs(getattr(got, f).cpu().numpy().astype(np.float64)
                               - np.asarray(getattr(want, f), np.float64)).max())
            errs[f] = max(errs.get(f, 0.0), err)
    return errs


def phase_colmap_reference(torch, device, seed, tmp):
    """The COLMAP scene at COLMAP_REFERENCE_SIZES: the poses read back by
    the port's COLMAP reader; the llff loader's arrays (images, cameras,
    the distortion) equal on the CPU and serving the card; the card's first
    three batches equal to the CPU loader's; the train step's in-step cast
    on the card against the host cast (COLMAP_CAST_TOL); then one cache
    step of ngp_yobo.gin at NGP_NARROW's widths with the rays cast in the
    step, GPU against CPU: every loss term and every gradient leaf, the
    limit GRAD_REL_L2_TOL bracketed by the CPU's noise floor (the cameras
    +-1 ulp) and two faults planted in the card's encoder forward (the step
    launches no scatter kernel: the final level's density normals take the
    plain encoder)."""
    import concurrent.futures
    import os

    import numpy as np

    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    root = os.path.join(tmp, "colmap_reference")
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        data_dir, _, _, pose_err = write_colmap_scene(torch, device, root,
                                                      COLMAP_REFERENCE_SIZES, pool, seed)
    config = _colmap_config(data_dir, *NGP_NARROW)
    loaded = [datasets.load_dataset("train", data_dir, config, device=dev)
              for dev in ("cpu", device)]
    arrays_equal = all(
        np.array_equal(getattr(loaded[0], k), getattr(loaded[1], k))
        for k in ("images", "camtoworlds", "pixtocams", "lights")) and all(
        np.array_equal(loaded[0].distortion_params[k], loaded[1].distortion_params[k])
        for k in loaded[0].distortion_params)
    same = True
    for _ in range(3):
        want, got = (ds.next_train() for ds in loaded)
        same &= _same_batch(torch, got, want)
    shape = tuple(loaded[0].images.shape)
    keys = sorted(loaded[0].distortion_params)
    del loaded
    in_step = _colmap_config(data_dir, *NGP_NARROW, "Config.cast_rays_in_train_step = True")
    dataset = datasets.load_dataset("train", data_dir, in_step, device=device)
    cast_errs = _colmap_cast_errs(torch, device, dataset,
                                  [dataset.next_train() for _ in range(3)])
    cast_ok = max(cast_errs.values()) <= COLMAP_CAST_TOL
    del dataset

    stage = (TRAINER_CACHE_STAGE + NGP_NARROW + COLMAP_BINDINGS
             + (f"Config.data_dir = '{data_dir}'", "Config.cast_rays_in_train_step = True"))

    def step(dev, fault=None, **kw):
        patch = dict(multires_grid_encode=_planted_encoder_fault(fault)) if fault else {}
        with _patched(hashgrid, **patch):
            return _trainer_step(torch, dev, seed, stage=stage, config_file=COLMAP_CONFIG, **kw)

    l_cpu, g_cpu, n_cpu = step("cpu")
    floor, floor_at, loss_floor = 0.0, None, 0.0
    for nudge in (1, -1):
        l_n, g_n, _ = step("cpu", nudge=nudge)
        v, at = _worst_grad_err(g_n, g_cpu)
        if v >= floor:
            floor, floor_at = v, at
        loss_floor = max(loss_floor, *(abs(l_n[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-30)
                                       for k in l_cpu))
    l_gpu, g_gpu, n_gpu = step(device)
    loss_errs = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-30) for k in l_cpu}
    err, err_at = _worst_grad_err(g_gpu, g_cpu)
    faults = {f: _worst_grad_err(step(device, fault=f)[1], g_cpu)
              for f in ("levels reversed", "finest level dropped")}
    tol = GRAD_REL_L2_TOL
    step_ok = (all(torch.isfinite(g).all() for g in g_gpu.values())
               and {"data", "cache_data"} <= set(l_cpu) and l_cpu["data"] != 0
               and max(loss_errs.values()) <= 1e-3 and n_cpu == _launch_counts()
               and n_gpu == _launch_counts() and floor <= tol and err <= tol
               and all(v > tol for v, _ in faults.values()))
    ok = arrays_equal and same and cast_ok and step_ok and pose_err < 1e-5
    print(f"colmap reference: {COLMAP_CONFIG}'s default llff loader on mip-NeRF 360's layout "
          f"(sparse/0 with one OPENCV camera {COLMAP_DISTORTION}, images_4/ of "
          f"{COLMAP_REFERENCE_SIZES[0]} JPEG views rendered on the card through the distorted "
          f"cameras): poses read back by the port's COLMAP reader within {pose_err:.2e}; images "
          f"{list(shape)}, distortion keys {keys}; the loader's arrays equal on the CPU and "
          f"serving the card={arrays_equal}; the card's first three batches equal to the CPU "
          f"loader's={same}; the train step's cast on the card against the host cast: "
          + ", ".join(f"{k} {v:.2e}" for k, v in cast_errs.items())
          + f" (tol {COLMAP_CAST_TOL}); the cache stage at reference widths with the rays cast "
          f"in the step (the Newton solve on the card), one step, the same weights, batch and "
          f"draws, gpu vs cpu: loss rel_err max={max(loss_errs.values()):.3e} (tol 1e-3; cpu vs "
          f"cpu with the cameras +-1 ulp: {loss_floor:.2e}) grad rel_l2_err max={err:.3e} at "
          f"{err_at} (tol {tol}; noise floor, cpu vs cpu with the cameras +-1 ulp: {floor:.3e} "
          f"at {floor_at}; planted in the card's encoder forward " + ", ".join(
              f"{f}: {v:.3e} at {at}" for f, (v, at) in faults.items())
          + f", each must exceed the tol); kernel launches gpu={n_gpu} cpu={n_cpu} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the COLMAP scene's reference phase failed")
    return dict(pose_err=pose_err, arrays_equal=arrays_equal, batches_equal=same,
                cast_abs_errs=cast_errs, cast_tol=COLMAP_CAST_TOL,
                loss_rel_err=max(loss_errs.values()), loss_noise_floor=loss_floor,
                grad_rel_l2_err=err, grad_err_at=err_at, noise_floor=floor,
                noise_floor_at=floor_at, faults={f: v for f, (v, _) in faults.items()}, tol=tol,
                launches=n_gpu["leveled"], losses=l_gpu)


def _colmap_flagship(torch, device, seed, data_dir, smi):
    """The flagship cache model (flagship.py, batch 8192) trained on the
    LLFF scene's batches, cast in the step on the card: COLMAP_FLAGSHIP_
    CHECKED steps with every leveled call held against its plain version,
    then COLMAP_FLAGSHIP_TIMED timed steps (next_train ahead of them); then
    as many on batches of the same scene cast on the host, for the in-step
    cast's share of the step; one leveled launch per step, asserted."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train
    from neural_radiance_caching_tpu_torch.utils import pytrees

    config = flagship.cache_config(dataset_loader="llff", data_dir=data_dir,
                                   factor=COLMAP_FACTOR, near=COLMAP_NEAR,
                                   cast_rays_in_train_step=True)
    torch.manual_seed(seed)
    dataset = datasets.load_dataset("train", data_dir, config, device=device)
    model = flagship.build_flagship_cache_model(config, device=device)
    state, _ = train.create_optimizer(config, model)
    train_step = train.create_train_step(model, config, dataset=dataset)
    rng = torch.Generator(device=device).manual_seed(seed + 43)
    total = COLMAP_FLAGSHIP_CHECKED + COLMAP_FLAGSHIP_TIMED
    t0 = time.perf_counter()
    batches = [dataset.next_train() for _ in range(total)]
    next_ms = 1e3 * (time.perf_counter() - t0) / total
    pixels = all(isinstance(b.rays, pytrees.Pixels) for b in batches)
    torch.cuda.reset_peak_memory_stats()
    scatter_cuda.reset_launch_count()
    calls, losses = [], []
    with _patched(scatter_cuda,
                  scatter_add_weighted_leveled=_checking_scatter("leveled", calls)):
        for batch in batches[:COLMAP_FLAGSHIP_CHECKED]:
            state, stats = train_step(rng, state, batch, 0.5)
            losses.append(stats["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[COLMAP_FLAGSHIP_CHECKED:]:
        state, stats = train_step(rng, state, batch, 0.5)
        losses.append(stats["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / COLMAP_FLAGSHIP_TIMED
    host = datasets.load_dataset("train", data_dir, dataclasses.replace(
        config, cast_rays_in_train_step=False), device=device)
    host_batches = [host.next_train() for _ in range(COLMAP_FLAGSHIP_TIMED)]
    host_step = train.create_train_step(model, host.config)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in host_batches:
        state, stats = host_step(rng, state, batch, 0.5)
        losses.append(stats["loss"])
    torch.cuda.synchronize()
    dt_host = (time.perf_counter() - t0) / COLMAP_FLAGSHIP_TIMED
    launches = dict(scatter_cuda.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    total += COLMAP_FLAGSHIP_TIMED
    ok = (pixels and _finite(losses) and launches == _launch_counts(leveled=total)
          and len(calls) == COLMAP_FLAGSHIP_CHECKED and all(c["ok"] for c in calls))
    print(f"colmap train (flagship): the flagship cache model "
          f"({sum(p.numel() for p in model.parameters())} params) batch {config.batch_size} on "
          f"the LLFF scene ({dataset.num_images} views of {dataset.height}x{dataset.width}), "
          f"Pixels cast in the step={pixels} (next_train {next_ms:.2f} host ms each): "
          f"{COLMAP_FLAGSHIP_CHECKED} checked steps, every leveled call against its plain "
          f"version (tol=|err|<={SUM_ORDER_TOL}*sum|w*ct|): " + "; ".join(
              f"idx{list(c['shape'])} max_abs_err={c['max_abs_err']:.3e} "
              f"{'ok' if c['ok'] else 'FAIL'}" for c in calls)
          + f"; {COLMAP_FLAGSHIP_TIMED} timed steps: step_ms={dt * 1e3:.2f} "
          f"rays_per_s={config.batch_size / dt:.0f} on [{smi}], then {COLMAP_FLAGSHIP_TIMED} "
          f"on batches cast on the host: step_ms={dt_host * 1e3:.2f}; peak {peak:.2f} GiB; losses "
          f"finite={_finite(losses)} first={losses[0]:.5f} last={losses[-1]:.5f}; kernel "
          f"launches={launches} (expected leveled {total}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("the flagship cache step on the COLMAP scene failed")
    result = dict(step_ms=dt * 1e3, rays_per_s=config.batch_size / dt, peak_gib=peak,
                  host_cast_step_ms=dt_host * 1e3, next_train_ms=next_ms, launches=launches["leveled"], checked=len(calls),
                  max_abs_err=max(c["max_abs_err"] for c in calls), losses=losses)
    del model, state, dataset, batches, train_step, host, host_batches, host_step
    return result


# Phase 42's runs, as `_disk_entry_runs` takes them: ngp_yobo.gin's cache
# stage on the scene at batch 8192, its rays cast on the host, then cast in
# the step; 3 timed steps each, no kernel launch. One held-out view, the
# second run's (30.0 and 26.6 s each at this size): both runs train the
# same weights (the same losses to the last digit in every call so far),
# and the second casts its view from Pixels, a path no other run takes,
# where the first's comes cast by the loader, as in every other disk run.
COLMAP_RUNS = (
    ("colmap_garden", ("-c", "ngp_yobo", "-t", "cache"), (8192,), None,
     lambda batch, trainer: {}, 3, (f"Config.factor = {COLMAP_FACTOR}",),
     dict(held_out=False)),
    ("colmap_garden_in_step", ("-c", "ngp_yobo", "-t", "cache"), (8192,), None,
     lambda batch, trainer: {}, 3, (f"Config.factor = {COLMAP_FACTOR}",
                                    "Config.cast_rays_in_train_step = True")),
)


def phase_colmap_train(torch, device, seed, smi, tmp):
    """The COLMAP scene written at COLMAP_SIZES (the writing's seconds and
    size), COLMAP_RUNS through the train_with_trainer entry point
    (`_disk_entry_runs`: loading, next_train, step ms, peak, an eval view,
    a checked step), then the flagship cache step on its batches
    (`_colmap_flagship`)."""
    import concurrent.futures
    import os

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        data_dir, nbytes, files, pose_err = write_colmap_scene(
            torch, device, os.path.join(tmp, "colmap"), COLMAP_SIZES, pool, seed)
    n, h, w = COLMAP_SIZES
    views = f"{n} views of {w}x{h} JPEG in images_4/"
    written = dict(data_dir=data_dir, write_s=time.perf_counter() - t0, gib=nbytes / 2**30,
                   files=files, views=views, pose_err=pose_err)
    print(f"colmap train: wrote mip-NeRF 360's layout (garden's factor-4 size: {views} "
          f"(4:2:0, "
          f"quality 95), sparse/0 with one OPENCV camera of {COLMAP_FACTOR * w}x"
          f"{COLMAP_FACTOR * h}, rendered on the card through the distorted cameras): {files} "
          f"files, {nbytes / 2**30:.3f} GiB in {written['write_s']:.1f}s", flush=True)
    scenes = {"colmap_garden": written, "colmap_garden_in_step": written}
    results = _disk_entry_runs(torch, device, "colmap train", COLMAP_RUNS, scenes, seed, None,
                               smi, tmp)
    flagship = _colmap_flagship(torch, device, seed, data_dir, smi)
    return {"written": written, **results, "flagship": flagship}


# Phase 43: training under OpenIllumination's three illuminations (the
# `_multi_illum` suffix of train_one_stage.py). Illuminations 011 and 009 of
# an object written by `write_real_scene` are the spheres rendered under the
# point light turned about +z by these angles; each illumination's Radiance
# env map (a sky and a sun at the light's azimuth, MULTI_ILLUM_ENV_SIZE) is
# written three levels above the object's `output/`.
MULTI_ILLUMS = {"013": 0.0, "011": 120.0, "009": 240.0}
MULTI_ILLUM_ENV_SIZE = (32, 64)
# The one form of the outputs JAX runs (the configs' own
# multiple_illumination_outputs = True is a reference gap), with the
# illumination embeddings of the four shaders on.
MULTI_ILLUM_BINDINGS = ("Config.multiple_illumination_outputs = False",) + tuple(
    f"{c}.use_illumination_feature = True"
    for c in ("NeRFMLP", "MaterialMLP", "LightMLP", "SurfaceLightFieldMLP"))
# The material stage's light_sampling is NaN in JAX and in the port: the
# light sampler's one-mixture output layer is read at the ray's light index
# (LightMLP.multiple_illumination_outputs = True in the configs), past its
# end for illuminations 011 and 009 (tests/test_torch_multi_illum.py).
MULTI_ILLUM_NAN_TERMS = ("light_sampling",)
# Phase 43's runs, as `_disk_entry_runs` takes them: open_egg's
# cache_multi_illum stage, then material_light_from_scratch_resample_multi_illum
# warm-started from it, each reading the test split at factor 8.
MULTI_ILLUM_RUNS = (
    ("open_egg", ("--scene", "obj_02_egg", "-t", "cache_multi_illum"), (8192, 4096, 2048), None,
     _open_launches, None, ("Config.test_factor = 8",) + MULTI_ILLUM_BINDINGS),
    ("open_egg", ("--scene", "obj_02_egg", "-t",
                  "material_light_from_scratch_resample_multi_illum", "--sample_factor", "8",
                  "--render_chunk_size", "1024"), (1024, 512, 256),
     "open_egg_cache_multi_illum", _open_material_launches, None,
     ("Config.test_factor = 8",) + MULTI_ILLUM_BINDINGS, dict(nan_terms=MULTI_ILLUM_NAN_TERMS)),
)


def hdr_bytes(rgb):
    """A Radiance RGBE file of `rgb` [H, W, 3] (float, >= 0), each scanline
    run-length encoded in the new style as literal runs of at most 128
    bytes."""
    import numpy as np

    h, w, _ = rgb.shape
    peak = rgb.max(-1)
    mantissa, exponent = np.frexp(peak)
    lit = peak > 1e-32
    scale = np.where(lit, mantissa * 256.0 / np.where(lit, peak, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(lit, exponent + 128, 0)
    body = bytearray()
    for y in range(h):
        body += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            row = rgbe[y, :, c].tobytes()
            for i in range(0, w, 128):
                body += bytes([len(row[i:i + 128])]) + row[i:i + 128]
    return b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w) + bytes(body)


def _illumination_light(angle):
    """SyntheticSpheres' point light turned about +z by `angle` degrees."""
    import numpy as np

    from neural_radiance_caching_tpu_torch.data import datasets

    a = np.radians(angle)
    rot = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
    return (rot @ datasets.SyntheticSpheres.LIGHT).astype(np.float32)


def _env_map(angle, size):
    """A sky brightening toward the zenith and a sun at the light's azimuth
    (equirectangular, [h, w, 3])."""
    import numpy as np

    h, w = size
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi
    sky = 0.2 + 0.8 * np.cos(theta / 2)[:, None, None] * np.array([0.5, 0.7, 1.0])
    rgb = np.broadcast_to(sky, (h, w, 3)).copy()
    sun = np.exp(-((theta[:, None] - 0.6) ** 2 + (phi[None] - np.radians(angle) - 0.5) ** 2)
                 / 0.02)
    return rgb + 40.0 * sun[..., None]


def write_illuminations(torch, device, data_dir, pool):
    """Illuminations 011 and 009 of the OpenIllumination object at
    `data_dir` (its `output/`): every view of both splits rendered on the
    card under MULTI_ILLUMS' light into `../Lights/{illumination}/
    raw_undistorted/` (the script's JPEG writer, 4:2:0 at quality 95), and
    the three env maps `../../../env_maps/hdrs/{illumination}.hdr`. Returns
    (bytes written, files)."""
    import json
    import os

    import numpy as np

    obj = os.path.dirname(os.path.normpath(data_dir))
    opencv = np.diag([1.0, -1.0, -1.0, 1.0])
    _, scale = REAL_CAMERAS["open_egg"]
    paths, jobs = [], []
    for illum, angle in MULTI_ILLUMS.items():
        path = os.path.normpath(os.path.join(data_dir, "..", "..", "..", "env_maps", "hdrs",
                                             f"{illum}.hdr"))
        _write(path, hdr_bytes(_env_map(angle, MULTI_ILLUM_ENV_SIZE)))
        paths.append(path)
        if illum == "013":
            continue
        lights = os.path.join(obj, "Lights", illum, "raw_undistorted")
        for split in ("train", "test"):
            with open(os.path.join(data_dir, f"transforms_{split}.json")) as f:
                frames = json.load(f)["frames"]
            poses = [(np.array(fr["transform_matrix"]) @ opencv)[:3] for fr in frames]
            pixtocams = [np.linalg.inv(np.array([[fr["fl_x"], 0, fr["cx"]],
                                                 [0, fr["fl_y"], fr["cy"]], [0, 0, 1]]))
                         for fr in frames]
            size = (frames[0]["h"], frames[0]["w"])
            views = _render_spheres(torch, device, np.array(poses), np.array(pixtocams), size,
                                    scale, light=_illumination_light(angle))
            for fr, (rgb, _, _) in zip(frames, views):
                path = os.path.join(lights, os.path.basename(fr["file_path"]) + ".JPG")
                pixels = np.round(rgb * 255).astype(np.uint8)
                jobs.append(pool.submit(lambda p=path, x=pixels: _write(p, jpeg_encode(x, 95)[0])))
                paths.append(path)
    for job in jobs:
        job.result()
    return sum(os.path.getsize(p) for p in paths), len(paths)


def phase_multi_illum_reference(torch, device, seed, tmp):
    """open_egg's layout at REAL_REFERENCE_SIZES with its three
    illuminations (`write_illuminations`): the multi-illumination loader
    serving the card gives the CPU loader's arrays, env-map tables and first
    three batches bit for bit (the light index of every illumination among
    them); one cache_multi_illum step at NGP_NARROW's widths with the
    embeddings on, GPU against CPU (`_gpu_vs_cpu_step`: every loss term,
    every gradient leaf, the CPU noise floor, two faults planted in the
    leveled kernel, every launch held against its plain version); then the
    configs' own Config.multiple_illumination_outputs = True through the
    entry point as train_one_stage.py builds its command, raising the
    reference gap's error before its first step."""
    import concurrent.futures
    import os

    import numpy as np

    from neural_radiance_caching_tpu_torch import train_one_stage, train_with_trainer
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.engine import configs, gin_config
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    config_file = REAL_SCENES["open_egg"]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        data_dir, _, _ = write_real_scene(torch, device, "open_egg",
                                          os.path.join(tmp, "multi_illum_reference"),
                                          REAL_REFERENCE_SIZES["open_egg"], pool)
        write_illuminations(torch, device, data_dir, pool)
    data = _disk_bindings("open_egg", data_dir) + ("Config.multi_illumination = True",)
    narrow = NGP_NARROW + (_narrow_slf_binding(config_file),) + MULTI_ILLUM_BINDINGS
    gin_config.clear_config()
    configs.load_config(config_files=[config_file], bindings=list(TRAINER_BINDINGS + narrow + data))
    config = configs.Config()
    gin_config.clear_config()
    loaded = [datasets.load_dataset("train", data_dir, config, device=dev)
              for dev in ("cpu", device)]
    arrays = all(np.array_equal(np.asarray(getattr(loaded[0], k)), np.asarray(getattr(loaded[1], k)))
                 for k in ("images", "light_idx", "camtoworlds", "pixtocams", "env_map",
                           "env_map_pmf", "env_map_pdf", "env_map_dirs"))
    same, light_idx = True, set()
    for _ in range(3):
        want, got = (ds.next_train() for ds in loaded)
        same &= _same_batch(torch, got, want)
        light_idx |= set(got.rays.light_idx.cpu().reshape(-1).tolist())
    served = (type(loaded[0]).__name__, tuple(loaded[0].images.shape),
              tuple(loaded[0].env_map.shape))
    del loaded
    r = _gpu_vs_cpu_step(torch, device, seed, TRAINER_CACHE_STAGE + narrow + data, config_file,
                         launches={"leveled": REAL_REFERENCE_LAUNCHES},
                         terms=("data", "cache_data", "mask"))

    # The suffix as the configs leave it.
    ckpt = os.path.join(tmp, "multi_illum_gap")
    command = train_one_stage.stage_command(
        ["--scene", "obj_02_egg", "-t", "cache_multi_illum", "--batch_size", "64", "--device",
         device], checkpoint_dir=ckpt)
    args = [c for c in command[3:] if c != "--logtostderr"] + [
        f"--gin_bindings={b}" for b in _disk_bindings("open_egg", data_dir)]
    scatter_cuda.reset_launch_count()
    gin_config.clear_config()
    try:
        train_with_trainer.main(args)
        gap = "no error"
    except NotImplementedError as e:
        gap = str(e)
    gin_config.clear_config()
    gap_ok = (gap.startswith("Config.multiple_illumination_outputs = True")
              and "reference gap" in gap and "nerf_shader.py:531" in gap
              and not os.path.exists(os.path.join(ckpt, "train_log.jsonl"))
              and dict(scatter_cuda.launches) == _launch_counts())
    ok = r["ok"] and same and arrays and light_idx == {0, 1, 2} and gap_ok
    print(f"multi illum reference: {served[0]} loader under Config.multi_illumination on "
          f"{config_file}'s layout with illuminations {', '.join(MULTI_ILLUMS)} (images "
          f"{list(served[1])}, env maps {list(served[2])}): arrays and tables equal on the CPU "
          f"and serving the card={arrays}, the card's first three batches equal to the CPU "
          f"loader's={same} with light indices {sorted(light_idx)}; cache_multi_illum at "
          f"reference widths with the embeddings, one step, the same weights, batch and draws, "
          f"gpu vs cpu: {_gpu_vs_cpu_text(r)}; the leveled calls against their plain version: "
          f"{_checked_text(r['checked'])}; kernel launches gpu={r['launches']} "
          f"cpu={r['cpu_launches']}; train_one_stage -t cache_multi_illum as the configs leave "
          f"multiple_illumination_outputs (True): raised before its first step={gap_ok} "
          f"({gap[:96]}...) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the multi-illumination scene's loader, GPU step or reference gap "
                             "disagrees")
    return dict({k: v for k, v in r.items()
                 if k not in ("ok", "checked", "cpu_launches", "grad_rel_l2_errs")},
                batches_equal=same, arrays_equal=arrays, light_idx=sorted(light_idx),
                gap_raised=gap_ok)


def phase_multi_illum_train(torch, device, seed, steps, smi, tmp, written):
    """Illuminations 011 and 009 and the three env maps written beside
    phase 38's open_egg object (`written`, its writing's seconds and size),
    then MULTI_ILLUM_RUNS through the train_with_trainer entry point
    (`_disk_entry_runs`: loading, next_train, step ms, peak, an eval view,
    a checked step)."""
    import concurrent.futures

    egg = dict(written["open_egg"])
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        nbytes, files = write_illuminations(torch, device, egg["data_dir"], pool)
    egg.update(write_s=time.perf_counter() - t0, gib=nbytes / 2**30, files=files,
               views=egg["views"] + f" under illuminations {', '.join(MULTI_ILLUMS)}")
    print(f"multi illum train: wrote illuminations {', '.join(list(MULTI_ILLUMS)[1:])} of "
          f"open_egg ({egg['views']}, rendered on the card under the light turned about +z) "
          f"and the env maps of {', '.join(MULTI_ILLUMS)} ({MULTI_ILLUM_ENV_SIZE[1]}x"
          f"{MULTI_ILLUM_ENV_SIZE[0]} Radiance HDR): {files} files, {nbytes / 2**30:.3f} GiB in "
          f"{egg['write_s']:.1f}s", flush=True)
    results = _disk_entry_runs(torch, device, "multi illum train", MULTI_ILLUM_RUNS,
                               {"open_egg": egg}, seed, steps, smi, tmp)
    return {"written": egg, **results}


# Phase 44: the loader options the port once refused (patch batches and
# the patch loss, SyntheticSpheres' physical shadings and its own
# multi-illumination, panoramic rays cast in the step, ORB's render path)
# and the triangle mesh with the sampler's mesh shortcut (ops/mesh.py).
OPTIONS_PATCH = ("Config.patch_size = 4", "Config.patch_loss_mult = 0.1",
                 "Config.bilateral_strength = 1.0", "Config.patch_variance_weighting = 1.0",
                 "Config.synthetic_spheres_shading = 'physical_glossy'",
                 "Config.synthetic_spheres_multi_illum = True")
OPTIONS_SHADINGS = ("legacy", "physical", "physical_glossy")
# The batch of phase 44's loaders and full-width steps.
OPTIONS_BATCH = 8192
# An icosphere over the spheres scene's central sphere: 5 subdivisions give
# 20,480 faces, 3 give 1,280 (the narrow reference step's). `intersect`
# tests 512 triangles at a time, as JAX's default: at 8192 rays each
# intermediate of a chunk is 8192 x 512 x 3 floats, 48 MiB.
MESH_SUBDIVISIONS = 5
MESH_REFERENCE_SUBDIVISIONS = 3
MESH_RAYS = 8192
MESH_CHUNK = 512
# The other chunks `intersect` is timed at, beside the one the sampler uses.
MESH_TIMED_CHUNKS = (2048, 4096)
# intersect on the card against the CPU: where both hit, t and the points
# to MESH_TOL relative and the normals to MESH_TOL; at most MESH_EDGE_RAYS
# rays may differ in hit or in face (a ray within rounding of an edge,
# where another triangle's face normal is as right).
MESH_TOL = 1e-5
MESH_EDGE_RAYS = 2
# The panorama cast in the step (float32 on the card) against the host's
# cast of the same pixels.
PANO_SIZE = (256, 512)
PANO_CAST_TOL = 1e-5
# ORB's render path: a small ORB scene (train views, test views, size), the
# orb_teapot cache model, two of the path's 120 frames rendered.
ORB_PATH_SIZES = (6, 2, 128)
ORB_PATH_FRAMES = (0, 60)


def _icosphere(subdivisions, radius):
    """A triangulated icosphere of `radius` at the origin: vertices [V, 3]
    float32, faces [F, 3] (20 x 4^subdivisions, outward)."""
    import numpy as np

    t = (1.0 + 5.0**0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
             (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
             (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
             (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.array(v) / np.linalg.norm(v) for v in verts]
    for _ in range(subdivisions):
        mid, new = {}, []

        def middle(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = middle(a, b), middle(b, c), middle(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    return (np.asarray(verts) * radius).astype(np.float32), np.asarray(faces, np.int64)


def _mesh_rays(torch, n, seed):
    """`n` rays (CPU) from a sphere of radius 3 toward points within 0.8 of
    the origin, so that most hit the 0.55 icosphere and some miss; the
    directions unnormalised."""
    gen = torch.Generator().manual_seed(seed)
    o = torch.randn((n, 3), generator=gen)
    o = 3.0 * o / o.norm(dim=-1, keepdim=True)
    target = (torch.rand((n, 3), generator=gen) - 0.5) * 1.6
    return o, (target - o) * (0.5 + 1.5 * torch.rand((n, 1), generator=gen))


def _with_mesh(model, mesh, use_mesh=True):
    """`model` whose forward takes `mesh` (the train step calls the model
    without one, as JAX's does)."""
    import functools

    return _patched(model, forward=functools.partial(model.forward, mesh=mesh,
                                                     use_mesh=use_mesh))


def _options_loaders(torch, device):
    """Patch batches (4 x 4, host-cast and Pixels) and the three shadings
    under multi-illumination, served on the card against the CPU loader:
    the scenes' arrays and the first three batches, bit for bit."""
    import numpy as np

    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.engine.configs import Config

    same, patches = True, 0
    for in_step in (False, True):
        cfg = Config(batch_size=OPTIONS_BATCH, num_dataset_images=8, patch_size=4,
                     synthetic_spheres_shading="physical_glossy",
                     synthetic_spheres_multi_illum=True, cast_rays_in_train_step=in_step)
        loaded = [datasets.SyntheticSpheres("train", None, cfg, resolution=128, device=dev)
                  for dev in ("cpu", device)]
        for _ in range(3):
            want, got = (d.next_train() for d in loaded)
            same &= _same_batch(torch, got, want)
            x = want.rays.pix_x_int.reshape(-1, 16)
            patches += int(((x - x[:, :1]) == torch.as_tensor([0, 1, 2, 3] * 4)).all(-1).sum())
    shadings = {}
    for shading in OPTIONS_SHADINGS:
        cfg = Config(batch_size=OPTIONS_BATCH, num_dataset_images=8, compute_albedo_metrics=True,
                     compute_normal_metrics=True, synthetic_spheres_shading=shading,
                     synthetic_spheres_multi_illum=True)
        cpu, card = (datasets.SyntheticSpheres("test", None, cfg, resolution=128, device=dev)
                     for dev in ("cpu", device))
        equal = all(np.array_equal(getattr(cpu, k), getattr(card, k))
                    for k in ("images", "alphas", "lights", "albedo_images", "normal_images"))
        equal &= _same_batch(torch, card.next_train(), cpu.next_train())
        shadings[shading] = dict(equal=equal, lights=len(np.unique(cpu.lights, axis=0)),
                                 mean_rgb=float(cpu.images[cpu.alphas > 0].mean()))
    return same, patches, shadings


def _options_pano_cast(torch, device, seed):
    """Equirectangular rays of two cameras cast in the step (float32 on the
    card) against the host's cast of the same pixels: the largest error of
    the directions, view directions, radii and image plane."""
    import numpy as np

    from neural_radiance_caching_tpu_torch.data import camera_utils
    from neural_radiance_caching_tpu_torch.utils import pytrees

    h, w = PANO_SIZE
    rng = np.random.RandomState(seed)
    n = MESH_RAYS
    pixtocams = np.diag(np.array([2.0 * np.pi / w, np.pi / h, 1.0], np.float32))[None]
    c2w = camera_utils.generate_spherical_poses(2, radius=2.0, seed=seed)
    lights = c2w[:, :3, -1]
    fields = dict(pix_x_int=rng.randint(0, w, n), pix_y_int=rng.randint(0, h, n),
                  lossmult=np.ones((n, 1), np.float32), near=np.full((n, 1), 0.1, np.float32),
                  far=np.full((n, 1), 5.0, np.float32),
                  cam_idx=rng.randint(0, 2, (n, 1)).astype(np.int32),
                  light_idx=np.zeros((n, 1), np.int32))
    pano = camera_utils.ProjectionType.PANORAMIC
    cameras = (pixtocams, c2w, None, None)
    host = camera_utils.cast_ray_batch(cameras, lights, pytrees.Pixels(**fields), camtype=pano)
    card = camera_utils.cast_ray_batch(
        camera_utils.cameras_to(cameras, device), torch.as_tensor(lights, device=device),
        pytrees.Pixels(**{k: torch.as_tensor(v, device=device) for k, v in fields.items()}),
        camtype=pano)
    errs = {k: float(np.abs(getattr(card, k).cpu().numpy() - getattr(host, k)).max())
            for k in ("origins", "directions", "viewdirs", "radii", "imageplane")}
    float32 = card.directions.dtype == torch.float32 and card.directions.is_cuda
    return errs, float32


def _options_intersect(torch, device, seed):
    """`intersect` on the 20,480-face icosphere at MESH_RAYS rays, the card
    against the CPU, and its time on the card."""
    from neural_radiance_caching_tpu_torch.ops import mesh

    v, f = _icosphere(MESH_SUBDIVISIONS, 0.55)
    o, d = _mesh_rays(torch, MESH_RAYS, seed)
    cpu = mesh.TriangleMesh(v, f).intersect(o, d, chunk=MESH_CHUNK)
    card_mesh = mesh.TriangleMesh(v, f, device=device)
    oc, dc = o.to(device), d.to(device)
    card = [x.cpu() for x in card_mesh.intersect(oc, dc, chunk=MESH_CHUNK)]
    t_c, p_c, n_c, fn_c, valid_c = cpu
    t_g, p_g, n_g, fn_g, valid_g = card
    both = valid_c & valid_g
    face_apart = (fn_g - fn_c).abs().max(-1).values > MESH_TOL
    odd = int((valid_c != valid_g).sum()) + int((face_apart & both).sum())
    keep = both & ~face_apart
    errs = dict(t=float(((t_g - t_c).abs() / t_c.abs())[keep].max()),
                points=float((p_g - p_c)[keep].abs().max()),
                normals=float((n_g - n_c)[keep].abs().max()),
                face_normals=float((fn_g - fn_c)[keep].abs().max()))
    ms = {chunk: _cuda_ms(lambda c=chunk: card_mesh.intersect(oc, dc, chunk=c))
          for chunk in (MESH_CHUNK,) + MESH_TIMED_CHUNKS}
    ok = odd <= MESH_EDGE_RAYS and max(errs.values()) <= MESH_TOL
    return dict(ok=ok, faces=len(f), rays=MESH_RAYS, hits=int(valid_c.sum()), edge_rays=odd,
                errs=errs, ms=ms[MESH_CHUNK], ms_by_chunk=ms)


def _mesh_reference_step(torch, device, seed):
    """The narrow flagship cache (phase 7's) with the 1,280-face icosphere
    under the mesh shortcut, one step GPU against CPU: the loss terms, every
    gradient leaf the mesh path reaches against the limit, bracketed by the
    CPU's noise floor (origins one ulp up) and two faults planted in the
    leveled kernel."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import mesh, scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    cfg = flagship.cache_config(batch_size=512, lr_delay_steps=0)
    params = _narrow(flagship.flagship_cache_params())
    batch = datasets.SyntheticSpheres("train", None, cfg, num_images=4, resolution=32,
                                      device="cpu").next_train()
    origins = batch.rays.origins
    nudged = batch.replace(rays=batch.rays.replace(
        origins=torch.nextafter(origins, torch.full_like(origins, float("inf")))))
    v, f = _icosphere(MESH_REFERENCE_SUBDIVISIONS, 0.55)

    def step(dev, b, fault=None):
        torch.manual_seed(seed)
        model = flagship.build_flagship_cache_model(cfg, params, device=dev)
        state, _ = train.create_optimizer(cfg, model)
        before = scatter_cuda.launches["leveled"]
        patch = dict(scatter_add_weighted_leveled=_planted_fault(fault)) if fault else {}
        with _patched(scatter_cuda, **patch), _with_mesh(model, mesh.TriangleMesh(v, f,
                                                                                  device=dev)):
            _, stats = train.create_train_step(model, cfg)(None, state, b.to(dev), 0.5)
        losses = {k: float(torch.as_tensor(val).detach()) for k, val in stats["losses"].items()}
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                 for k, p in model.named_parameters()}
        return losses, grads, scatter_cuda.launches["leveled"] - before

    l_cpu, g_cpu, n_cpu = step("cpu", batch)
    floor, floor_at = _worst_grad_err(step("cpu", nudged)[1], g_cpu)
    l_gpu, g_gpu, n_gpu = step(device, batch)
    loss_errs = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    err, err_at = _worst_grad_err(g_gpu, g_cpu)
    faults = {fault: _worst_grad_err(step(device, batch, fault)[1], g_cpu)
              for fault in ("taps rotated", "finest level dropped")}
    unreached = sorted(k for k, g in g_cpu.items() if float(g.abs().max()) == 0)
    ok = (all(torch.isfinite(g).all() for g in g_gpu.values()) and max(loss_errs.values()) <= 1e-4
          and n_cpu == 0 and n_gpu == 1 and floor <= GRAD_REL_L2_TOL and err <= GRAD_REL_L2_TOL
          and all(val > GRAD_REL_L2_TOL for val, _ in faults.values())
          and any(k.startswith("sampler.mlps.0.") for k in unreached))
    return dict(ok=ok, faces=len(f), loss_rel_err=max(loss_errs.values()),
                loss_rel_errs=loss_errs, grad_rel_l2_err=err, grad_err_at=err_at,
                noise_floor=floor, noise_floor_at=floor_at,
                faults={k: val for k, (val, _) in faults.items()},
                fault_at={k: at for k, (_, at) in faults.items()}, launches=n_gpu,
                unreached=len(unreached), losses=l_gpu)


def phase_options_reference(torch, device, seed):
    """Phase 44's reference: the card against the CPU on the patch batch
    stream, the three sphere shadings under multi-illumination, the
    panorama cast in the step (against the host's cast), `intersect` on the
    20,480-face icosphere at 8192 rays, one narrow synthetic_spheres.gin
    cache step on patch batches with the patch loss (`_gpu_vs_cpu_step`)
    and one narrow flagship cache step under the mesh shortcut."""
    same, patches, shadings = _options_loaders(torch, device)
    pano_errs, pano_f32 = _options_pano_cast(torch, device, seed)
    hits = _options_intersect(torch, device, seed)
    patch = _gpu_vs_cpu_step(torch, device, seed, TRAINER_CACHE_STAGE + OPTIONS_PATCH,
                             TRAINER_REF_CONFIG, launches={"leveled": 1},
                             terms=("data", "cache_data", "patch", "cache_patch"))
    mesh_step = _mesh_reference_step(torch, device, seed)
    shadings_ok = all(r["equal"] and r["lights"] == 8 for r in shadings.values())
    pano_ok = pano_f32 and max(pano_errs.values()) <= PANO_CAST_TOL
    ok = (same and patches == 6 * OPTIONS_BATCH // 16 and shadings_ok and pano_ok and hits["ok"]
          and patch["ok"] and mesh_step["ok"])
    print(f"options reference: patch batches (4x4, batch {OPTIONS_BATCH}, physical_glossy, "
          f"multi-illumination, host-cast and Pixels) card vs cpu equal={same}, {patches} "
          f"patches of contiguous 4x4 pixels; shadings under multi-illumination card vs cpu: "
          + ", ".join(f"{k} equal={r['equal']} lights={r['lights']} mean rgb {r['mean_rgb']:.4f}"
                      for k, r in shadings.items())
          + f"; panorama {PANO_SIZE[1]}x{PANO_SIZE[0]} cast in the step (float32 on the card="
          f"{pano_f32}) vs the host cast: max err "
          + ", ".join(f"{k} {v:.2e}" for k, v in pano_errs.items())
          + f" (tol {PANO_CAST_TOL}); intersect {hits['faces']} faces x {hits['rays']} rays "
          f"({hits['hits']} hits) card vs cpu: "
          + ", ".join(f"{k} {v:.2e}" for k, v in hits["errs"].items())
          + f" (tol {MESH_TOL}), rays apart at an edge {hits['edge_rays']} (at most "
          f"{MESH_EDGE_RAYS}), on the card ms by chunk "
          + ", ".join(f"{c}: {t:.3f}" for c, t in hits["ms_by_chunk"].items())
          + f" (the sampler's chunk {MESH_CHUNK}; medians of 11, CUDA events); "
          f"synthetic_spheres.gin cache step on patch batches with the patch loss, gpu vs cpu: "
          f"{_gpu_vs_cpu_text(patch)}; leveled calls against their plain version: "
          f"{_checked_text(patch['checked'])}; narrow flagship cache under the mesh shortcut "
          f"({mesh_step['faces']} faces, use_mesh), gpu vs cpu: loss rel_err max="
          f"{mesh_step['loss_rel_err']:.3e} (tol 1e-4) grad rel_l2_err max="
          f"{mesh_step['grad_rel_l2_err']:.3e} at {mesh_step['grad_err_at']} (tol "
          f"{GRAD_REL_L2_TOL}; noise floor, cpu vs cpu with origins +1 ulp: "
          f"{mesh_step['noise_floor']:.3e} at {mesh_step['noise_floor_at']}; planted "
          + ", ".join(f"{k}: {v:.3e} at {mesh_step['fault_at'][k]}"
                      for k, v in mesh_step["faults"].items())
          + f", each must exceed the tol; {mesh_step['unreached']} leaves unreached, the "
          f"proposal MLPs among them) launches gpu={mesh_step['launches']} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("a loader option or the mesh shortcut disagrees on the card")
    return dict(patch_batches_equal=same, shadings=shadings, pano_cast_errs=pano_errs,
                intersect=hits, launches=patch["launches"]["leveled"] + mesh_step["launches"],
                max_abs_err=patch["max_abs_err"],
                patch_step={k: v for k, v in patch.items()
                            if k not in ("ok", "checked", "cpu_launches", "grad_rel_l2_errs")},
                mesh_step={k: v for k, v in mesh_step.items() if k != "ok"})


def _options_mesh_train(torch, device, seed, steps, smi):
    """The full-width flagship cache model's train step under the mesh
    shortcut (the 20,480-face icosphere handed to the model), batch 8192 on
    SyntheticSpheres (8 views at 128^2): one step with every leveled call
    held against its plain version, 3 warmup + `steps` timed; the step's
    ms, peak GiB and `intersect`'s ms at the batch."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import mesh, scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    config = flagship.cache_config(batch_size=OPTIONS_BATCH)
    torch.manual_seed(seed)
    model = flagship.build_flagship_cache_model(config, device=device)
    dataset = datasets.SyntheticSpheres("train", None, config, num_images=8, resolution=128,
                                        device=device)
    v, f = _icosphere(MESH_SUBDIVISIONS, 0.55)
    tri = mesh.TriangleMesh(v, f, device=device)
    state, _ = train.create_optimizer(config, model)
    train_step = train.create_train_step(model, config)
    rng = torch.Generator(device=device).manual_seed(seed + 44)
    batches = [dataset.next_train() for _ in range(8)]
    warmup, calls = 3, []
    torch.cuda.reset_peak_memory_stats()
    with _with_mesh(model, tri):
        with _patched(scatter_cuda, scatter_add_weighted_leveled=_checking_scatter(
                "leveled", calls)):
            state, stats = train_step(rng, state, batches[0], 0.5)
        losses = [stats["loss"]]
        scatter_cuda.reset_launch_count()
        for i in range(warmup):
            state, stats = train_step(rng, state, batches[(1 + i) % 8], 0.5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            state, stats = train_step(rng, state, batches[(1 + warmup + i) % 8], 0.5)
            losses.append(stats["loss"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
    launches = dict(scatter_cuda.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rays = batches[0].rays
    intersect_ms = _cuda_ms(lambda: tri.intersect(rays.origins, rays.directions,
                                                  chunk=MESH_CHUNK))
    hit = float(tri.intersect(rays.origins, rays.directions)[4].float().mean())
    finite = _finite(float(v) for v in losses)
    ok = (finite and launches == _launch_counts(leveled=warmup + steps) and len(calls) == 1
          and all(c["ok"] for c in calls))
    print(f"options train (mesh): flagship cache model batch {config.batch_size} on "
          f"SyntheticSpheres 8x128^2 with the {len(f)}-face icosphere handed to the model "
          f"(use_mesh: one surface sample per ray, {hit:.3f} of the rays hit): checked step "
          f"{_checked_text(calls)}; {warmup} warmup + {steps} timed steps: step_ms={dt * 1e3:.2f} "
          f"rays_per_s={config.batch_size / dt:.0f} on [{smi}]; intersect_ms={intersect_ms:.3f} "
          f"(chunk {MESH_CHUNK}, median of 11, CUDA events); peak {peak_gib:.2f} GiB; losses "
          f"finite={finite}; kernel launches={launches} (expected leveled {warmup + steps}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the flagship step under the mesh shortcut failed")
    return dict(step_ms=dt * 1e3, rays_per_s=config.batch_size / dt, intersect_ms=intersect_ms,
                hit_share=hit, peak_gib=peak_gib, faces=len(f), steps=steps, warmup=warmup,
                launches=launches["leveled"], max_abs_err=max(c["max_abs_err"] for c in calls))


def _options_orb_path(torch, device, seed, tmp):
    """A small ORB scene (ORB_PATH_SIZES) written as phase 33's, its
    intrinsics shared in the transforms' header (with one set per frame,
    the path's frames past the test split's count have no intrinsics: JAX
    and the port raise alike, tests/test_torch_loader_options.py), loaded
    with Config.vis_render_path on the card (the test split the 120-frame
    ellipse, each frame test image 0), its poses against the CPU loader's;
    two of its frames rendered through orb_ngp_yobo_teapot.gin's cache
    model (random weights) as the trainer renders a held-out view."""
    import concurrent.futures
    import json
    import os

    import numpy as np

    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.engine import gin_config

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        data_dir, _, _ = write_disk_scene(torch, device, "orb_teapot",
                                          os.path.join(tmp, "orb_path"), ORB_PATH_SIZES, pool)
    for split in ("train", "test"):
        path = os.path.join(data_dir, f"transforms_{split}.json")
        with open(path) as f:
            meta = json.load(f)
        shared = ("fl_x", "fl_y", "cx", "cy")
        meta.update({k: meta["frames"][0][k] for k in shared})
        for frame in meta["frames"]:
            for k in shared:
                del frame[k]
        _write(path, json.dumps(meta).encode())
    bindings = (TRAINER_CACHE_STAGE + _disk_bindings("orb_teapot", data_dir)
                + ("Config.vis_render_path = True", f"Config.jax_rng_seed = {seed}"))
    trainer = _trainer_setup(torch, device, DISK_SCENES["orb_teapot"], bindings)
    gin_config.clear_config()
    path = trainer.test_dataset
    cpu = datasets.load_dataset("test", data_dir, trainer.config, device="cpu")
    poses_equal = (np.array_equal(path.camtoworlds, cpu.camtoworlds)
                   and np.array_equal(path.images, cpu.images))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finite = True
    for frame in ORB_PATH_FRAMES:
        rendering, _ = trainer.render_test_view(frame, 1.0)
        finite &= bool(np.isfinite(rendering["rgb"]).all())
    torch.cuda.synchronize()
    s = (time.perf_counter() - t0) / len(ORB_PATH_FRAMES)
    ok = (path.num_images == 120 and poses_equal and finite
          and np.array_equal(path.images[0], path.images[119]))
    print(f"options train (ORB render path): orb_ngp_yobo_teapot.gin cache model on a "
          f"{ORB_PATH_SIZES[2]}^2 ORB scene with Config.vis_render_path: {path.num_images} path "
          f"frames (test image 0 each), poses and images equal to the CPU loader's={poses_equal}; "
          f"frames {list(ORB_PATH_FRAMES)} rendered ({path.height}x{path.width}, finite={finite}) "
          f"in {s:.2f} s per frame {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("ORB's render path failed")
    return dict(frames=path.num_images, rendered=list(ORB_PATH_FRAMES), s_per_frame=s,
                size=[path.height, path.width])


def phase_options_train(torch, device, seed, steps, smi, tmp):
    """Phase 44's train part: synthetic_spheres.gin's cache stage through the
    train_with_trainer entry point at batch 8192 with the physical glossy
    shading, its multi-illumination and 4 x 4 patches with the patch loss
    (3 warmup + `steps` timed, one leveled launch per step, then one step
    with every leveled call held against its plain version); the flagship
    cache step under the mesh shortcut; ORB's render path."""
    import os

    warmup = 3
    ckpt = os.path.join(tmp, "options_spheres_cache")
    args = [f"--gin_configs={TRAINER_REF_CONFIG}", f"--device={device}"] + [
        f"--gin_bindings={b}" for b in TRAINER_BINDINGS + TRAINER_CACHE_STAGE + OPTIONS_PATCH + (
            f"Config.batch_size = {OPTIONS_BATCH}", f"Config.checkpoint_dir = '{ckpt}'",
            f"Config.early_exit_steps = {warmup + steps}", f"Config.print_every = {warmup + steps}",
            f"Config.jax_rng_seed = {20200823 + seed}", "Trainer.save_results = False")]
    run = _entry_point_run(torch, args, None, ckpt, warmup, steps)
    trainer, dt, losses = run["trainer"], run["step_s"], run["losses"]
    calls, checked_launches, stats = _checked_step(torch, trainer, {"leveled": 1})
    total = warmup + steps
    finite = _finite(losses.values()) and all(
        f"loss/{k}" in losses for k in ("data", "patch", "cache_patch"))
    ok = (finite and run["launches"] == _launch_counts(leveled=total) and len(calls) == 1
          and all(c["ok"] for c in calls) and checked_launches == _launch_counts(leveled=1)
          and trainer.batch_size == OPTIONS_BATCH and math.isfinite(run["metrics"]["psnr"]))
    print(f"options train (patches): train_with_trainer {TRAINER_REF_CONFIG} cache stage with "
          f"{', '.join(OPTIONS_PATCH)}, batch {trainer.batch_size} ({trainer.batch_size // 16} "
          f"patches), {warmup} warmup + {steps} timed steps: step_ms={dt * 1e3:.2f} rays_per_s="
          f"{trainer.batch_size / dt:.0f} on [{smi}]; peak {run['peak_gib']:.2f} GiB; losses "
          f"finite and present={finite} patch={losses.get('loss/patch', float('nan')):.4e}; "
          f"kernel launches={run['launches']} (expected leveled {total}); checked step "
          f"{_checked_text(calls)}; held-out view psnr={run['metrics']['psnr']:.2f}; entry point "
          f"{run['wall']:.1f}s {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the spheres cache stage on patch batches failed")
    patches = dict(step_ms=dt * 1e3, rays_per_s=trainer.batch_size / dt,
                   peak_gib=run["peak_gib"], batch=trainer.batch_size, steps=steps,
                   warmup=warmup, launches=run["launches"]["leveled"],
                   max_abs_err=max(c["max_abs_err"] for c in calls), losses=losses)
    del trainer, run, stats
    mesh_train = _options_mesh_train(torch, device, seed, steps, smi)
    orb = _options_orb_path(torch, device, seed, tmp)
    return dict(patches=patches, mesh=mesh_train, orb_path=orb)


# Phase 45: the sampling and encoding options the port once refused
# (models/geometry.py, sampler.py, sample_net.py, integrator.py, grids.py,
# nerf_model.py and material_model.py; ops/coord.py, ops/hashgrid.py).
# Option set A, on the flagship cache: the final density MLP's control
# points by the julier basis with a Cholesky root and a scale-aware grid
# query (unscented_scale_mult, the scale tracked through the warp), the
# feature filter on primary rays with its far field, density noise,
# corrected and offset normals, glorot_uniform kernels; the proposal MLPs'
# covariance options; the sampler's near anneal, normal, far-field and
# uniform radii, the sample network and the "piecewise" ray warp; a random
# background (0, 1) with the colour network; Config.volume_variate.
# normalize_uniform_weights is left to set B's secondary rays: on a primary
# ray it sums the opacity to exactly 1, the kink of the background weight
# max(0, 1 - opacity), where a one-ulp difference in the summed opacity
# flips the ray's gradient (the card against the CPU as much as the CPU
# against itself). Option set B, on the flagship material model: the
# secondary rays' vertical, horizontal and backwards filters and their
# uniform radius with normalize_uniform_weights, the backfacing near
# filter, Config.volume_variate_secondary. Config.volume_variate_material
# raises on the steady material model in both packages (its one-channel
# direct_rgb against the cache's three); it runs on the transient material
# model, held here at reference widths.
SAMPLING_BATCH = 8192
SAMPLING_MATERIAL_BATCH = 1536
SAMPLING_REF_BATCH = 512
# The reference steps' planes threshold: the set-A cache step (512 x 32 x 7
# julier points) and the material step's secondary samples take the planes
# kernel at reference widths, as the full-width cache step does.
SAMPLING_PLANES_MIN_POINTS = 4096
SET_A_CONFIG = dict(volume_variate=True, volume_variate_passes=["direct"])
SET_B_CONFIG = dict(volume_variate_secondary=True, volume_variate_passes_secondary=["direct"])
# The grid steps' appearance grids in the cache shader (the density MLP on
# IPE, so that the step launches no scatter kernel).
SAMPLING_GRID_KINDS = {"triplane": dict(grid_size=128, num_features=8),
                       "tensorf": dict(grid_size=96, num_features=8, num_components=8)}
# The kernel checks' inputs: the flagship grid (8 levels, 3 dense, T = 2^19,
# F = 4) on the julier points (2 x 3 + 1 per sample) of 8192 camera rays x
# 32 samples.
SAMPLING_KERNEL_RAYS = 8192
SAMPLING_KERNEL_SAMPLES = 32
# Scatter launches per full-width step: the set-A cache step's final-level
# encoder backward over 8192 x 32 x 7 = 1,835,008 points (planes); the set-B
# material step's as the flagship material step's.
_SAMPLING_CACHE_LAUNCHES_PER_STEP = {"leveled": 0, "leveled_skip": 0, "planes": 1, "rows": 0}


def _set_a(params):
    """Option set A on flagship cache params."""
    from neural_radiance_caching_tpu_torch.ops import coord

    p = copy.deepcopy(params)
    sp = p["sampler_params"]
    mlps = [dict(m) for m in sp["mlp_params_per_level"]]
    for m in mlps[:2]:
        m.update(isotropize_gaussians=True, gaussian_covariance_scale=1.5,
                 gaussian_covariance_pad=1e-4, weight_init="glorot_uniform")
    mlps[2].update(unscented_mip_basis="julier", unscented_sqrt_fn="cholesky",
                   unscented_scale_mult=0.5, use_feature_filter=True,
                   use_feature_filter_secondary_only=False, use_feature_filter_far_field=True,
                   feature_filter_radius=1.0, feature_filter_size=64, density_noise=0.1,
                   use_corrected_normals=True, enable_normals_offset=True,
                   weight_init="glorot_uniform", warp_fn=coord.contract_radius_2)
    sp["mlp_params_per_level"] = tuple(mlps)
    sp.update(near_anneal_rate=0.8, use_normal_radius=True, normal_radius=0.8,
              use_far_field_radius=True, far_field_radius=1.5, use_uniform_radius=True,
              uniform_radius=1.2, use_uniform_radius_secondary_only=False,
              use_sample_network=True, raydist_fn="piecewise")
    p["integrator_params"] = dict(bg_intensity_range=(0.0, 1.0), use_color_net=True,
                                  net_depth=2, net_width=64)
    return p


def _set_b(params):
    """Option set B on flagship material params."""
    p = copy.deepcopy(params)
    sp = p["cache_model_params"]["sampler_params"]
    mlps = [dict(m) for m in sp["mlp_params_per_level"]]
    mlps[2].update(use_backfacing_near=True, backfacing_target="normals_to_use",
                   backfacing_near=0.3)
    sp["mlp_params_per_level"] = tuple(mlps)
    sp.update(use_vertical_filter=True, vertical_fov=1.2, use_horizontal_filter=True,
              horizontal_fov=1.3, use_backwards_filter=True, use_uniform_radius=True,
              uniform_radius=1.5, normalize_uniform_weights=True)
    return p


def _grid_params(kind):
    """The flagship cache with a `kind` appearance grid in its shader and its
    final density MLP on IPE (no hash grid)."""
    from neural_radiance_caching_tpu_torch import flagship

    p = _narrow(flagship.flagship_cache_params())
    sp = p["sampler_params"]
    mlps = [dict(m) for m in sp["mlp_params_per_level"]]
    mlps[2].update(use_grid=False, max_deg_point=8, primary_grid_level_clamp=None,
                   secondary_grid_level_clamp=None)
    sp["mlp_params_per_level"] = tuple(mlps)
    sp["grid_params_per_level"] = (None, None, None)
    p["shader_params"].update(use_grid=True, grid_representation=kind,
                              grid_params=SAMPLING_GRID_KINDS[kind])
    return p


def _model_step(torch, device, seed, build, batch, fault=None, fault_kind="planes",
                checked=None, planes_min=SAMPLING_PLANES_MIN_POINTS):
    """One train step of the model `build(device)` returns, (model, config),
    on `device` (`batch` a tuple of batches: one micro-step of gradient
    accumulation on each, and the gradients read are the mean the update
    took); the draws from a CPU generator, so both devices see the same
    numbers; a fault planted in the `fault_kind` kernel, or every call of
    both kernels held against its plain version (`checked`)."""
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    torch.manual_seed(seed)
    model, cfg = build(device)
    state, _ = train.create_optimizer(cfg, model)
    before = dict(scatter_cuda.launches)
    if fault:
        patch = {f"scatter_add_weighted_{fault_kind}": _planted_fault(fault, fault_kind)}
    elif checked is not None:
        patch = {f"scatter_add_weighted_{k}": _checking_scatter(k, checked)
                 for k in ("leveled", "planes")}
    else:
        patch = {}
    with _patched(hashgrid, PLANES_MIN_POINTS=planes_min), _patched(scatter_cuda, **patch):
        rng = torch.Generator().manual_seed(seed + 45)
        step = train.create_train_step(model, cfg)
        micro = batch if isinstance(batch, tuple) else (batch,)
        for b in micro:
            state, stats = step(rng, state, b.to(device), 0.5)
    if len(micro) > 1 and not (state.step == len(micro) and state.grad_accum is None):
        raise AssertionError(f"{len(micro)} micro-steps left step {state.step} and an "
                             "accumulator")
    losses = {k: float(torch.as_tensor(v).detach()) for k, v in stats["losses"].items()}
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
             for k, p in model.named_parameters()}
    return losses, grads, {k: scatter_cuda.launches[k] - before[k] for k in before}


# A loss term of a narrow step on the card is held relative to its CPU value
# or this, the larger: a term under it is float32 noise (set D's eikonal term
# reads ~1e-16, its normals being unit vectors in both packages).
LOSS_FLOOR = 1e-9


def _model_gpu_vs_cpu(torch, device, seed, build, batch, launches, tol, fault_kind="planes",
                      exclude=(), chaotic_above=None, planes_min=SAMPLING_PLANES_MIN_POINTS):
    """`_model_step` on the card against the CPU (`batch` a batch, or a
    tuple of micro-step batches): every loss term, every gradient leaf
    (each hash level its own; but those in `exclude`, which no loss
    reaches) against the
    limit `tol`, bracketed by the CPU's noise floor (the origins +-1 ulp)
    and two faults planted in the `fault_kind` kernel (none where the step
    launches no kernel); the card's calls held against their plain version
    and `launches` {kind: count} pinned; a loss term is held relative to
    its CPU value or LOSS_FLOOR, the larger. The readings, with `ok`."""
    step = functools.partial(_model_step, planes_min=planes_min)
    l_cpu, g_cpu, n_cpu = step(torch, "cpu", seed, build, batch)
    keys = [k for k in g_cpu if k not in exclude]
    leaf_floor = {}

    def nudge(b, side):
        o = b.rays.origins
        return b.replace(rays=b.rays.replace(origins=torch.nextafter(o, torch.full_like(o, side))))

    for side in (float("inf"), float("-inf")):
        nudged = (tuple(nudge(b, side) for b in batch) if isinstance(batch, tuple)
                  else nudge(batch, side))
        for k, v in _grad_errs(step(torch, "cpu", seed, build, nudged)[1], g_cpu).items():
            leaf_floor[k] = max(v, leaf_floor.get(k, 0.0))
    # Leaves (hash levels) whose own floor passes `chaotic_above` (by default
    # the limit) are chaotic under this step's loss: held finite, listed, and
    # left out of the comparison.
    chaotic = sorted(k for k, v in leaf_floor.items() if v > (chaotic_above or tol))
    held = {k: v for k, v in leaf_floor.items() if k not in chaotic and k.split("[")[0] in keys}
    floor_at = max(held, key=held.get)
    floor = held[floor_at]
    checked = []
    l_gpu, g_gpu, n_gpu = step(torch, device, seed, build, batch, checked=checked)
    loss_errs = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), LOSS_FLOOR) for k in l_cpu}

    def worst(g):
        errs = {k: v for k, v in _grad_errs(g, g_cpu).items() if k in held}
        at = max(errs, key=errs.get)
        return errs[at], at

    err, err_at = worst(g_gpu)
    faults = {f: worst(step(torch, device, seed, build, batch, f, fault_kind)[1])
              for f in ("taps rotated", "finest level dropped") if sum(launches.values())}
    ok = (all(torch.isfinite(g).all() for g in g_gpu.values())
          and max(loss_errs.values()) <= 1e-3 and n_cpu == _launch_counts()
          and n_gpu == _launch_counts(**launches) and all(c["ok"] for c in checked)
          and len(checked) == sum(launches.values()) and floor <= tol and err <= tol
          and all(v > tol for v, _ in faults.values()))
    return dict(ok=ok, loss_rel_err=max(loss_errs.values()), loss_rel_errs=loss_errs,
                grad_rel_l2_err=err, grad_err_at=err_at, noise_floor=floor,
                noise_floor_at=floor_at, chaotic={k: leaf_floor[k] for k in chaotic},
                chaotic_above=chaotic_above or tol,
                faults={f: v for f, (v, _) in faults.items()},
                fault_at={f: at for f, (_, at) in faults.items()}, tol=tol, launches=n_gpu,
                max_abs_err=max((c["max_abs_err"] for c in checked), default=0.0),
                losses=l_gpu)


def _model_text(r):
    worst_loss = max(r["loss_rel_errs"], key=r["loss_rel_errs"].get)
    return (f"loss rel_err max={r['loss_rel_err']:.3e} at {worst_loss} (tol 1e-3) grad "
            f"rel_l2_err max="
            f"{r['grad_rel_l2_err']:.3e} at {r['grad_err_at']} (tol {r['tol']}; noise floor, "
            f"cpu vs cpu with origins +-1 ulp: {r['noise_floor']:.3e} at {r['noise_floor_at']}; "
            + (", ".join(f"planted {f}: {v:.3e} at {r['fault_at'][f]}"
                         for f, v in r["faults"].items()) + ", each must exceed the tol"
               if r["faults"] else "no fault planted: the step launches no kernel")
            + (f"; held finite only, their own floor above {r['chaotic_above']}: "
               + ", ".join(f"{k} {v:.2e}" for k, v in r["chaotic"].items()) if r["chaotic"]
               else "")
            + f") launches={ {k: v for k, v in r['launches'].items() if v} } "
            f"{'ok' if r['ok'] else 'FAIL'}")


def _sampling_batch(torch, cfg, size=32):
    from neural_radiance_caching_tpu_torch.data import datasets

    return datasets.SyntheticSpheres("train", None, cfg, num_images=4, resolution=size,
                                     device="cpu").next_train()


def _variate_material_raises(torch):
    """Config.volume_variate_material on the steady material model raises,
    naming the direct_rgb reshape (JAX's TypeError at its first call)."""
    from neural_radiance_caching_tpu_torch import flagship

    cfg = flagship.material_config(batch_size=16, volume_variate_material=True)
    model = flagship.build_flagship_material_model(cfg, _narrow_material(), device="cpu")
    batch = _sampling_batch(torch, cfg, 8)
    try:
        with torch.no_grad():
            model(torch.Generator().manual_seed(0), batch.rays, train_frac=0.5, train=True)
    except TypeError as e:
        return "direct_rgb" in str(e)
    return False


def phase_sampling_reference(torch, device, seed):
    """Phase 45's reference: narrow steps on the card against the CPU (the
    path the CPU tests hold against the JAX package): the flagship cache
    under set A and the flagship material model under set B (planes faults),
    the transient material model under Config.volume_variate_material
    (leveled faults), and the cache with a triplane and a TensoRF
    appearance grid (no kernel launched)."""
    from neural_radiance_caching_tpu_torch import flagship

    cfg_a = flagship.cache_config(batch_size=SAMPLING_REF_BATCH, lr_delay_steps=0,
                                  **SET_A_CONFIG)
    params_a = _set_a(_narrow(flagship.flagship_cache_params()))
    set_a = _model_gpu_vs_cpu(
        torch, device, seed,
        lambda dev: (flagship.build_flagship_cache_model(cfg_a, params_a, device=dev), cfg_a),
        _sampling_batch(torch, cfg_a), {"planes": 1}, GRAD_REL_L2_TOL)

    cfg_b = flagship.material_config(batch_size=MATERIAL_REF_BATCH, lr_delay_steps=0,
                                     **SET_B_CONFIG)
    params_b = _set_b(_narrow_material())
    set_b = _model_gpu_vs_cpu(
        torch, device, seed,
        lambda dev: (flagship.build_flagship_material_model(cfg_b, params_b, device=dev), cfg_b),
        _sampling_batch(torch, cfg_b), _MATERIAL_LAUNCHES_PER_STEP, MATERIAL_GRAD_REL_L2_TOL,
        exclude=_MATERIAL_UNREACHED)
    steady_raises = _variate_material_raises(torch)

    cfg_t = dataclasses.replace(_transient_material_ref_config(), volume_variate_material=True)
    params_t = _narrow_transient_material()
    tmat = _model_gpu_vs_cpu(
        torch, device, seed,
        lambda dev: (flagship.build_flagship_transient_material_model(cfg_t, params_t,
                                                                      device=dev), cfg_t),
        _sampling_batch(torch, cfg_t), _TRANSIENT_MATERIAL_LAUNCHES_PER_STEP,
        TRANSIENT_MATERIAL_GRAD_REL_L2_TOL, fault_kind="leveled",
        exclude=_TRANSIENT_MATERIAL_UNREACHED,
        chaotic_above=TRANSIENT_MATERIAL_GRAD_REL_L2_TOL / 2, planes_min=1 << 20)

    cfg_g = flagship.cache_config(batch_size=SAMPLING_REF_BATCH, lr_delay_steps=0)
    grids_ref = {kind: _model_gpu_vs_cpu(
        torch, device, seed,
        lambda dev, kind=kind: (flagship.build_flagship_cache_model(
            cfg_g, _grid_params(kind), device=dev), cfg_g),
        _sampling_batch(torch, cfg_g), {}, GRAD_REL_L2_TOL) for kind in SAMPLING_GRID_KINDS}

    ok = (set_a["ok"] and set_b["ok"] and tmat["ok"] and steady_raises
          and all(r["ok"] for r in grids_ref.values()))
    print(f"sampling reference: narrow flagship cache under option set A (julier/cholesky, "
          f"scale-aware query, covariance options, feature filter + far field, density noise, "
          f"corrected + offset normals, glorot_uniform, near anneal, radii, sample network, "
          f"piecewise warp, random background + colour net, volume variate), batch "
          f"{SAMPLING_REF_BATCH}, gpu vs cpu: {_model_text(set_a)}; narrow flagship material "
          f"under set B (secondary filters, uniform radius + normalize_uniform_weights, "
          f"backfacing near, volume_variate_secondary), batch {MATERIAL_REF_BATCH}: "
          f"{_model_text(set_b)}; volume_variate_material on the steady model raises naming "
          f"direct_rgb={steady_raises}; narrow transient material under volume_variate_material"
          f", batch {TRANSIENT_MATERIAL_REF_BATCH}: {_model_text(tmat)}; "
          + "; ".join(f"narrow cache with a {kind} appearance grid: {_model_text(r)}"
                      for kind, r in grids_ref.items()), flush=True)
    if not ok:
        raise AssertionError("a sampling option disagrees on the card")
    strip = lambda r: {k: v for k, v in r.items() if k not in ("ok", "loss_rel_errs")}  # noqa
    return dict(set_a=strip(set_a), set_b=strip(set_b), transient_variate=strip(tmat),
                grids={k: strip(r) for k, r in grids_ref.items()},
                steady_variate_material_raises=steady_raises,
                launches={"planes": set_a["launches"]["planes"] + set_b["launches"]["planes"],
                          "leveled": set_b["launches"]["leveled"] + tmat["launches"]["leveled"]},
                max_abs_err=max(set_a["max_abs_err"], set_b["max_abs_err"],
                                tmat["max_abs_err"]))


def _julier_points(torch, device, seed):
    """The flagship grid's inputs [8192, 32, 7, 3] in [0, 1]^3: the julier
    control points (Cholesky root) of cone Gaussians along camera rays as
    _primary_sample_points draws them (pixel radius 2.8e-3), warped by the
    flagship contraction."""
    from neural_radiance_caching_tpu_torch.ops import coord, render

    gen = torch.Generator(device=device).manual_seed(seed + 45)
    n, s = SAMPLING_KERNEL_RAYS, SAMPLING_KERNEL_SAMPLES
    c = torch.randn((n, 3), generator=gen, device=device)
    origins = 4.0 * c / c.norm(dim=-1, keepdim=True)
    d = -origins / 4.0 + 0.3 * torch.randn((n, 3), generator=gen, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    t, _ = torch.sort(2.0 + 4.0 * torch.rand((n, s + 1), generator=gen, device=device), dim=-1)
    radii = torch.full((n, 1), 2.8e-3, device=device)
    means, covs = render.cast_rays(t, origins, d, radii, "cone", diag=False)
    control = coord.unscented_transform(means, covs, "julier", "cholesky", axis=-2)
    return (coord.contract_radius_2(control) + 2.0) / 4.0


def _encoder_check(torch, device, x, reduce, kind, label):
    """The flagship grid's table gradient at `x` under `reduce`, the `kind`
    kernel's backward against the plain backward; the kernel call's inputs
    timed (phase_kernel_path). The readings."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.models import grids
    from neural_radiance_caching_tpu_torch.ops import hashgrid, scatter_cuda

    params = flagship.flagship_cache_params()["sampler_params"]["grid_params_per_level"][2]
    grid = grids.HashEncoding(**params).to(device)
    statics = dict(grid_sizes=tuple(int(s) for s in grid.grid_sizes),
                   table_size=grid.hash_map_size, dense_offsets=grid.dense_offsets,
                   interpolation="simplex", multisample_reduce=reduce)
    gen = torch.Generator(device=device).manual_seed(7)
    levels, m = len(statics["grid_sizes"]), x.shape[-2]
    shape = x.shape[:-2] + ((levels, m * 4) if reduce == "concat" else (levels * 4,))
    ct = torch.randn(shape, generator=gen, device=device)
    fn_key = "scatter_fn" if kind == "leveled" else "planes_scatter_fn"

    def grads(fn):
        grid.zero_grad(set_to_none=True)
        f = hashgrid.multires_grid_encode(x, grid.hash_levels, grid.dense_levels,
                                          **{fn_key: fn}, **statics)
        f.backward(ct)
        return grid.hash_levels.grad.clone(), grid.dense_levels.grad.clone()

    capture, calls = {}, []
    before = dict(scatter_cuda.launches)
    with _patched(scatter_cuda, **{f"scatter_add_weighted_{kind}": _checking_scatter(
            kind, calls, capture)}):
        h_k, d_k = grads(None)
    launched = {k: scatter_cuda.launches[k] - before[k] for k in before}
    h_p, d_p = grads(getattr(scatter_cuda, f"scatter_add_weighted_{kind}_plain"))
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in ((h_k, h_p), (d_k, d_p))]
    del h_k, d_k, h_p, d_p, grid
    ok = (launched == _launch_counts(**{kind: 1}) and max(errs) <= 1e-5 and len(calls) == 1
          and calls[0]["ok"])
    points = x.numel() // 3
    print(f"sampling encoder ({reduce}): flagship grid backward, {points} julier points "
          f"({SAMPLING_KERNEL_RAYS} rays x {SAMPLING_KERNEL_SAMPLES} samples x {m}), 8 levels, "
          f"{kind} kernel vs plain backward rel_err hash={errs[0]:.3e} dense={errs[1]:.3e} "
          f"(tol 1e-5 of max |grad|), the call against its plain version "
          f"{_checked_text(calls)}, launches={launched} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"the {reduce} encoder's kernel backward disagrees")
    path = phase_kernel_path(kind, capture, statics["grid_sizes"], label)
    return dict(max_abs_err=calls[0]["max_abs_err"], rel_err=max(errs), points=points,
                updates=capture["idx"].numel(), **path)


def phase_sampling_kernels(torch, device, seed):
    """Phase 45's kernels: the flagship grid on 1,835,008 julier points, the
    concat encoder's backward on the leveled kernel (8 levels x 7.3M taps)
    and the mean encoder's on the planes kernel, each against its plain
    backward, the kernel calls timed against index_add_ and their bound."""
    x = _julier_points(torch, device, seed)
    concat = _encoder_check(torch, device, x, "concat", "leveled",
                            "concat encoder's updates (julier points of 8192 x 32 samples)")
    mean = _encoder_check(torch, device, x, "mean", "planes",
                          "mean encoder's updates (julier points of 8192 x 32 samples)")
    del x
    return dict(concat=concat, mean=mean)


def _sampling_train_run(torch, device, seed, steps, smi, build, batch_size, per_step, label,
                        micro=1, views=(8, 128)):
    """The full-width model `build()` returns on SyntheticSpheres (`views`:
    8 views at 128^2): one step with every scatter call held against its
    plain version, 3 warmup + `steps` timed; step ms, peak GiB, launches.
    A step is `micro` calls of the train step (the micro-steps of one
    update under gradient accumulation), and `per_step` counts per update."""
    from neural_radiance_caching_tpu_torch.data import datasets
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda
    from neural_radiance_caching_tpu_torch.parallel import train

    torch.manual_seed(seed)
    model, config = build()
    dataset = datasets.SyntheticSpheres("train", None, config, num_images=views[0],
                                        resolution=views[1], device=device)
    state, _ = train.create_optimizer(config, model)
    micro_step = train.create_train_step(model, config)

    def train_step(rng, state, batch, train_frac):
        for _ in range(micro):
            state, stats = micro_step(rng, state, batch, train_frac)
        return state, stats

    rng = torch.Generator(device=device).manual_seed(seed + 45)
    batches = [dataset.next_train() for _ in range(8)]
    warmup, calls = 3, []
    torch.cuda.reset_peak_memory_stats()
    with _patched(scatter_cuda, **{f"scatter_add_weighted_{k}": _checking_scatter(k, calls)
                                   for k in ("leveled", "planes")}):
        state, stats = train_step(rng, state, batches[0], 0.5)
    losses = [stats["loss"]]
    scatter_cuda.reset_launch_count()
    for i in range(warmup):
        state, stats = train_step(rng, state, batches[(1 + i) % 8], 0.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        state, stats = train_step(rng, state, batches[(1 + warmup + i) % 8], 0.5)
        losses.append(stats["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launches = dict(scatter_cuda.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finite = _finite(float(v) for v in losses)
    per_kind = {k: sum(c["kind"] == k for c in calls) for k in per_step}
    ok = (finite and launches == {k: v * (warmup + steps) for k, v in per_step.items()}
          and per_kind == per_step and all(c["ok"] for c in calls))
    print(f"{label}: batch {batch_size}"
          + (f" x {micro} micro-steps per update" if micro > 1 else "")
          + f" on SyntheticSpheres {views[0]}x{views[1]}^2: checked "
          f"step {_checked_text(calls)}; {warmup} warmup + {steps} timed steps: step_ms="
          f"{dt * 1e3:.2f} rays_per_s={batch_size * micro / dt:.0f} on [{smi}]; peak "
          f"{peak_gib:.2f} GiB; "
          f"losses finite={finite}; kernel launches={launches} (expected per step {per_step}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"the full-width step failed ({label})")
    return dict(step_ms=dt * 1e3, rays_per_s=batch_size * micro / dt, peak_gib=peak_gib,
                batch=batch_size, micro_steps=micro, steps=steps, warmup=warmup,
                launches={k: v for k, v in launches.items() if v},
                max_abs_err=max(c["max_abs_err"] for c in calls),
                max_abs_err_by_kernel={k: max(c["max_abs_err"] for c in calls if c["kind"] == k)
                                       for k in per_step if per_step[k]})


def phase_sampling_train(torch, device, seed, steps, smi):
    """Phase 45's full-width steps: the flagship cache under set A at 8192
    (1 planes launch per step) and the flagship material model under set B
    at 1536."""
    from neural_radiance_caching_tpu_torch import flagship

    def cache():
        config = flagship.cache_config(batch_size=SAMPLING_BATCH, **SET_A_CONFIG)
        return flagship.build_flagship_cache_model(
            config, _set_a(flagship.flagship_cache_params()), device=device), config

    def material():
        config = flagship.material_config(batch_size=SAMPLING_MATERIAL_BATCH, **SET_B_CONFIG)
        return flagship.build_flagship_material_model(
            config, _set_b(flagship.flagship_material_params()), device=device), config

    return dict(
        cache=_sampling_train_run(torch, device, seed, steps, smi, cache, SAMPLING_BATCH,
                                  _SAMPLING_CACHE_LAUNCHES_PER_STEP,
                                  "sampling train (flagship cache, set A)"),
        material=_sampling_train_run(torch, device, seed, steps, smi, material,
                                     SAMPLING_MATERIAL_BATCH, _MATERIAL_LAUNCHES_PER_STEP,
                                     "sampling train (flagship material, set B)"))


# Phase 46: the material shader's options, the remaining data and extra
# losses, and the train-step options (models/material_shader.py,
# ops/render_utils.py, ops/stepfun.py, parallel/losses.py, extra_losses.py,
# train.py). Option set C, on the flagship material model: the anisotropic
# BRDF correction (the default correction's input and the half and
# difference vectors), reparam_roughness, emission with a window and variate
# weights, MIS off under a stratified 2D generator, stopgrad_light=False,
# resample_cache=False, and the extra losses emission, maximum_radiance and
# extra_ray (two more material-model forwards along turned view directions,
# the second without a graph). The per-point and global corrections are
# held alone, as functions. Set C': the residual albedo with its loss, one
# diffuse lobe over all secondary samples (separate integration off), one
# material for the scene, and material_correlation by its weights (0 on the
# model path, as in JAX: the SLF variate's irradiance_cache never reaches
# the shader results it reads). The steady shader without indirect lobes
# raises naming JAX's failure. Set D, on the flagship cache: the rawnerf
# loss under the combined and norm scalings, the non-spline interlevel
# loss, the eikonal loss on every level (whose density normals take the
# plain encoder: no kernel), normalize_weight (0: no model emits the
# weights it ties) and debug_mode; without the eikonal loss, gradient
# accumulation over two micro-steps. The transient cache under
# rawnerf_transient_unbiased with a two-scale Gaussian pyramid.
OPTIONS_MATERIAL_BATCH = 1536
OPTIONS_CACHE_BATCH = 8192
OPTIONS_TRANSIENT_BATCH = 2048
GAUSS_CONFIG = dict(transient_gauss_sigma_scales=[(1.0, 1.0), (2.0, 0.5)],
                    transient_gauss_constant_scale=0.5, data_loss_gauss_mult=0.5)
SET_C_CONFIG = dict(extra_losses={"emission": {"main": {"mult": 1.0}}},
                    emission_zero_loss_mult=0.1, emission_constant_loss_mult=1.0,
                    maximum_radiance_loss_weight=0.1, extra_ray_loss_mult=0.5, is_material=True)
SET_C_PRIME_CONFIG = dict(extra_losses={"residual_albedo": {"main": {"mult": 1.0}}},
                          material_correlation_weight_albedo=0.1,
                          material_correlation_weight_other=0.1, is_material=True)
SET_D_CONFIG = dict(data_loss_type="rawnerf", use_combined_rawnerf=True, use_norm_rawnerf=True,
                    use_spline_interlevel_loss=False, eikonal_loss_mult=0.1,
                    eikonal_coarse_loss_mult=0.01, normalize_weight_loss_weight=0.1,
                    debug_mode=True)
# Set D without the eikonal loss (so that the final level's encoder takes
# the kernel) and with two micro-steps per update.
SET_D_ACCUM_CONFIG = dict({k: v for k, v in SET_D_CONFIG.items() if "eikonal" not in k},
                          grad_accum_steps=2)
# Scatter launches per update. Set C: the flagship material step's, twice:
# the extra rays' forward has its own encoder backwards (the cache's primary
# samples and the material grid, leveled; its secondary samples, planes),
# and its debias forward none. Set D with accumulation: the final level's
# leveled backward in each of the two micro-steps. The transient cache: its
# final level's.
_OPTIONS_SET_C_LAUNCHES = {"leveled": 4, "leveled_skip": 0, "planes": 2, "rows": 0}
_OPTIONS_ACCUM_LAUNCHES = {"leveled": 2, "leveled_skip": 0, "planes": 0, "rows": 0}
_OPTIONS_TRANSIENT_LAUNCHES = {"leveled": 1, "leveled_skip": 0, "planes": 0, "rows": 0}
# The function checks: the largest relative error (of the output's largest
# entry) the card may read against the CPU on the same inputs, each about
# five times its reading on an H100 (none would pass in half precision).
# The GGX density's 1 - cos^2 (1 - a^2) cancels at small roughness, where
# the card's fused multiply-adds round otherwise: the visible-normal pdfs
# read 8.4e-5 and 3.3e-5, the directions 1.0e-5; lossfun_outer 4.1e-6, the
# pyramid and the corrections 1.4e-7 to 2.6e-7.
OPTIONS_FUNCTION_TOLS = {"vndf_directions": 5e-5, "vndf_pdf": 4e-4, "vndf_mis_pdf": 4e-4,
                         "dtof_to_gauss": 1e-5, "lossfun_outer": 2e-5,
                         "brdf_correction_per_point": 1e-5, "brdf_correction_global": 1e-5}


def _set_c(params):
    """Option set C on material params."""
    from neural_radiance_caching_tpu_torch.ops import render_utils

    p = copy.deepcopy(params)
    p["shader_params"] = dict(
        p["shader_params"], use_brdf_correction=True, anisotropic_brdf_correction=True,
        reparam_roughness=True, use_diffuse_emission=True, emission_window_frac=0.8,
        emission_variate_weight_start=0.5, emission_variate_weight_end=1.0, use_mis=False,
        stratified_sampling=True, random_generator_2d=render_utils.RandomGenerator2D.create(
            8, True), stopgrad_light=False, resample_cache=False)
    return p


def _set_c_prime(params):
    """Option set C' on material params."""
    p = copy.deepcopy(params)
    p["shader_params"] = dict(p["shader_params"], use_residual_albedo=True,
                              separate_integration_diffuse_specular=False,
                              use_constant_material=True)
    return p


def _set_d(params):
    """Set D's density normals on every level of cache params (the eikonal
    loss reads them)."""
    p = copy.deepcopy(params)
    sp = p["sampler_params"]
    sp["mlp_params_per_level"] = tuple(dict(m, disable_density_normals=False,
                                            normals_for_filter_only=False)
                                       for m in sp["mlp_params_per_level"])
    return p


def _steady_indirect_off_raises(torch):
    """MaterialMLP.use_indirect=False raises at construction, naming JAX's
    failure (its irradiance left the float 0.0)."""
    from neural_radiance_caching_tpu_torch import flagship

    params = _narrow_material()
    params["shader_params"] = dict(params["shader_params"], use_indirect=False)
    try:
        flagship.build_flagship_material_model(flagship.material_config(batch_size=16), params,
                                               device="cpu")
    except NotImplementedError as e:
        return "reference gap" in str(e) and "'reshape'" in str(e)
    return False


def _rel_err(got, want):
    got, want = got.detach(), want.detach()
    return float((got.float().cpu() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def phase_material_options_functions(torch, device, seed):
    """Phase 46's new functions alone, the card against the CPU on the same
    inputs at full-width shapes: the visible-normal GGX sampler's
    directions and pdfs (1536 x 32 draws), the Gaussian pyramid of the
    flagship transient's residual (2048 rays x 700 bins), the mip-NeRF 360
    proposal loss (8192 rays, 32 against 64 intervals), and the per-point
    and global BRDF corrections (1536 points x 16 samples)."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.engine.configs import Config
    from neural_radiance_caching_tpu_torch.models import material_shader
    from neural_radiance_caching_tpu_torch.ops import render_utils, stepfun

    gen = torch.Generator().manual_seed(seed + 46)

    def dirs(shape):
        d = torch.randn(shape + (3,), generator=gen)
        d[..., 2] = d[..., 2].abs() + 0.05
        return d / d.norm(dim=-1, keepdim=True)

    errs = {}
    shape = (OPTIONS_MATERIAL_BATCH, 32)
    u1, u2 = (torch.rand(shape, generator=gen) * 0.98 + 0.01 for _ in range(2))
    wo, wi = dirs(shape), dirs(shape)
    alpha = torch.rand(shape + (1,), generator=gen) * 0.85 + 0.05
    sampler = render_utils.MicrofacetSampler(sample_visible=True)
    ref = sampler.sample_directions(None, u1, u2, wo, alpha, None, {})
    got = sampler.sample_directions(None, u1.to(device), u2.to(device), wo.to(device),
                                    alpha.to(device), None, {})
    errs["vndf_directions"] = _rel_err(got[0], ref[0])
    errs["vndf_pdf"] = _rel_err(got[1], ref[1])
    errs["vndf_mis_pdf"] = _rel_err(
        sampler.pdf(wo.to(device), wi.to(device), alpha.to(device), {}),
        sampler.pdf(wo, wi, alpha, {}))

    x = torch.randn((OPTIONS_TRANSIENT_BATCH, flagship.TRANSIENT_N_BINS, 3), generator=gen)
    scales = GAUSS_CONFIG["transient_gauss_sigma_scales"]
    errs["dtof_to_gauss"] = _rel_err(
        render_utils.dtof_to_gauss(x.to(device), scales, 0.5),
        render_utils.dtof_to_gauss(x, scales, 0.5))

    def stepfn(n):
        t = torch.sort(torch.rand((OPTIONS_CACHE_BATCH, n + 1), generator=gen), dim=-1).values
        w = torch.rand((OPTIONS_CACHE_BATCH, n), generator=gen)
        return t, w / w.sum(dim=-1, keepdim=True)

    (t, w), (t_env, w_env) = stepfn(32), stepfn(64)
    errs["lossfun_outer"] = _rel_err(
        stepfun.lossfun_outer(*(a.to(device) for a in (t, w, t_env, w_env))),
        stepfun.lossfun_outer(t, w, t_env, w_env))

    n = 16
    feature = torch.randn((OPTIONS_MATERIAL_BATCH, 1, 64), generator=gen)
    samples = {k: dirs((OPTIONS_MATERIAL_BATCH, n)) for k in (
        "local_viewdirs", "local_lightdirs", "global_viewdirs", "global_lightdirs")}
    for form in ("per_point", "global"):
        torch.manual_seed(seed)
        shader = material_shader.MaterialMLP(
            config=Config(), density_feature_dim=8, use_grid=False, bottleneck_width=64,
            net_width_brdf=64, use_brdf_correction=True, **{f"{form}_brdf_correction": True})
        want = shader.get_brdf_correction(feature, samples, n)
        shader.to(device)
        got = shader.get_brdf_correction(feature.to(device),
                                         {k: v.to(device) for k, v in samples.items()}, n)
        errs[f"brdf_correction_{form}"] = _rel_err(got, want)
    torch.cuda.synchronize()
    ok = sorted(errs) == sorted(OPTIONS_FUNCTION_TOLS) and all(
        v <= OPTIONS_FUNCTION_TOLS[k] for k, v in errs.items())
    print("material options functions: the card against the CPU on the same inputs, relative "
          "max error: " + ", ".join(f"{k}={v:.3e} (tol {OPTIONS_FUNCTION_TOLS[k]})"
                                    for k, v in errs.items())
          + f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("a new function disagrees on the card")
    return errs


# The mean gradient of an update under gradient accumulation against its
# plain version on the card, as a relative L2 per leaf: the same gradients
# averaged in another order, and the leveled kernel's atomic sums in
# another order (~1e-7).
ACCUM_PLAIN_TOL = 1e-4


def _accumulation_against_plain(torch, device, seed, build, build_plain, batches):
    """`_model_step` with a micro-step on each of `batches` on `device`, its
    mean gradient against its plain version: each batch's step alone
    (`build_plain`, no accumulation; the step cleans and clips its
    gradient) from the same weights and the same continuing draws,
    averaged. A planted fault, the last micro-gradient alone, must read
    above the limit. The readings, with `ok`."""
    from neural_radiance_caching_tpu_torch.parallel import train

    rng = torch.Generator().manual_seed(seed + 45)
    grads, clipped = [], []
    for b in batches:
        torch.manual_seed(seed)
        model, cfg = build_plain(device)
        state, _ = train.create_optimizer(cfg, model)
        train.create_train_step(model, cfg)(rng, state, b.to(device), 0.5)
        grads.append({k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                      for k, p in model.named_parameters()})
        norms = {}
        for k, g in grads[-1].items():
            norms[k.split(".")[0]] = norms.get(k.split(".")[0], 0.0) + float(g.square().sum())
        clipped.append(any(v ** 0.5 > 0.999 * cfg.grad_max_norm for v in norms.values()))
    plain = {k: sum(g[k] for g in grads) / len(grads) for k in grads[0]}
    _, accumulated, _ = _model_step(torch, device, seed, build, batches, planes_min=1 << 20)
    errs = _grad_errs(accumulated, plain)
    at = max(errs, key=errs.get)
    fault = max(_grad_errs(grads[-1], plain).values())
    return dict(ok=errs[at] <= ACCUM_PLAIN_TOL < fault and all(clipped), rel_l2_err=errs[at],
                at=at, fault=fault, clipped=clipped, tol=ACCUM_PLAIN_TOL)


def phase_material_options_reference(torch, device, seed):
    """Phase 46's reference: narrow steps on the card against the CPU (the
    path the CPU tests hold against the JAX package): the flagship material
    model under sets C and C' (planes faults), the flagship cache under set
    D (no kernel: its density normals take the plain encoder) and under
    gradient accumulation (two micro-steps on two batches; leveled faults;
    and its mean gradient against its plain version on the card), the
    transient cache under the Gaussian pyramid (leveled faults); and the
    steady shader without indirect lobes raising."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.data import datasets

    def material(setter, extra):
        cfg = flagship.material_config(batch_size=MATERIAL_REF_BATCH, lr_delay_steps=0, **extra)
        params = setter(_narrow_material())
        return (lambda dev: (flagship.build_flagship_material_model(cfg, params, device=dev),
                             cfg)), cfg

    build_c, cfg_c = material(_set_c, SET_C_CONFIG)
    set_c = _model_gpu_vs_cpu(torch, device, seed, build_c, _sampling_batch(torch, cfg_c),
                              _OPTIONS_SET_C_LAUNCHES, MATERIAL_GRAD_REL_L2_TOL,
                              exclude=_MATERIAL_UNREACHED)
    build_cp, cfg_cp = material(_set_c_prime, SET_C_PRIME_CONFIG)
    set_cp = _model_gpu_vs_cpu(torch, device, seed, build_cp, _sampling_batch(torch, cfg_cp),
                               _MATERIAL_LAUNCHES_PER_STEP, MATERIAL_GRAD_REL_L2_TOL,
                               exclude=_MATERIAL_UNREACHED)
    indirect_raises = _steady_indirect_off_raises(torch)

    cfg_d = flagship.cache_config(batch_size=SAMPLING_REF_BATCH, lr_delay_steps=0,
                                  **SET_D_CONFIG)
    params_d = _set_d(_narrow(flagship.flagship_cache_params()))
    set_d = _model_gpu_vs_cpu(
        torch, device, seed,
        lambda dev: (flagship.build_flagship_cache_model(cfg_d, params_d, device=dev), cfg_d),
        _sampling_batch(torch, cfg_d), {}, GRAD_REL_L2_TOL)
    # Two micro-steps on two batches, each micro-gradient clipped per module
    # to 0.01 (which the narrow model's gradients pass) before the mean.
    cfg_a = flagship.cache_config(batch_size=SAMPLING_REF_BATCH, lr_delay_steps=0,
                                  grad_max_norm=0.01, **dict(SET_D_ACCUM_CONFIG, debug_mode=False))
    params_a = _narrow(flagship.flagship_cache_params())
    data = datasets.SyntheticSpheres("train", None, cfg_a, num_images=4, resolution=32,
                                     device="cpu")
    micro = (data.next_train(), data.next_train())

    def build_a(dev, cfg=cfg_a):
        return flagship.build_flagship_cache_model(cfg, params_a, device=dev), cfg

    accum = _model_gpu_vs_cpu(torch, device, seed, build_a, micro, {"leveled": 2},
                              GRAD_REL_L2_TOL, fault_kind="leveled", planes_min=1 << 20)
    accum_plain = _accumulation_against_plain(
        torch, device, seed, build_a,
        functools.partial(build_a, cfg=dataclasses.replace(cfg_a, grad_accum_steps=1)), micro)

    cfg_t = dataclasses.replace(_transient_ref_config(), **GAUSS_CONFIG)
    params_t = _narrow_transient(False)
    gauss = _model_gpu_vs_cpu(
        torch, device, seed,
        lambda dev: (flagship.build_flagship_transient_cache_model(cfg_t, params_t, device=dev),
                     cfg_t),
        _sampling_batch(torch, cfg_t), {"leveled": 1}, TRANSIENT_GRAD_REL_L2_TOL,
        fault_kind="leveled", exclude=_TRANSIENT_UNREACHED, planes_min=1 << 20)

    terms = {"set_c": ("emission", "extra_ray", "maximum_radiance"),
             "set_c_prime": ("residual_albedo", "material_correlation"),
             "set_d": ("eikonal", "normalize_weight", "interlevel_0", "interlevel_1")}
    runs = dict(set_c=set_c, set_c_prime=set_cp, set_d=set_d)
    present = all(all(t in runs[r]["losses"] for t in ts) for r, ts in terms.items())
    ok = (all(r["ok"] for r in (set_c, set_cp, set_d, accum, gauss, accum_plain))
          and indirect_raises and present and set_cp["losses"]["material_correlation"] == 0.0)
    print(f"material options reference: narrow flagship material under option set C "
          f"(anisotropic BRDF correction, reparam_roughness, emission window + variate weights, MIS off with a "
          f"stratified generator, stopgrad_light=False, resample_cache=False; emission, "
          f"maximum_radiance and extra_ray losses), batch {MATERIAL_REF_BATCH}, gpu vs cpu: "
          f"{_model_text(set_c)}; under set C' (residual albedo + its loss, one diffuse lobe, "
          f"constant material, material_correlation by weight = "
          f"{set_cp['losses'].get('material_correlation')}): {_model_text(set_cp)}; steady "
          f"use_indirect=False raises naming JAX's failure={indirect_raises}; narrow flagship "
          f"cache under set D (rawnerf combined + norm, non-spline interlevel, eikonal on every "
          f"level, normalize_weight, debug_mode), batch {SAMPLING_REF_BATCH}: "
          f"{_model_text(set_d)}; with gradient accumulation, 2 micro-steps per update on 2 "
          f"batches, each clipped to 0.01 per module: {_model_text(accum)}; its mean gradient "
          f"against its plain version, the two batches' steps alone averaged, on the card: "
          f"rel_l2_err max={accum_plain['rel_l2_err']:.3e} at {accum_plain['at']} (tol "
          f"{ACCUM_PLAIN_TOL}; planted, the last micro-gradient alone: "
          f"{accum_plain['fault']:.3e}, must exceed the tol; micro-gradients clipped "
          f"{accum_plain['clipped']}) {'ok' if accum_plain['ok'] else 'FAIL'}; narrow "
          f"transient cache under the two-scale Gaussian pyramid, batch {TRANSIENT_REF_BATCH} x {TRANSIENT_REF_BINS} bins: {_model_text(gauss)}; loss "
          f"terms present={present}", flush=True)
    if not ok:
        raise AssertionError("a material, loss or step option disagrees on the card")
    strip = lambda r: {k: v for k, v in r.items() if k not in ("ok", "loss_rel_errs")}  # noqa
    readings = dict(set_c=set_c, set_c_prime=set_cp, set_d=set_d, accumulation=accum,
                    gauss_pyramid=gauss)
    return dict(**{k: strip(r) for k, r in readings.items()},
                accumulation_against_plain=strip(accum_plain),
                steady_indirect_off_raises=indirect_raises,
                launches={kind: sum(r["launches"][kind] for r in readings.values())
                          for kind in ("leveled", "planes")},
                max_abs_err=max(r["max_abs_err"] for r in readings.values()))


def phase_material_options_train(torch, device, seed, steps, smi):
    """Phase 46's full-width steps: the flagship material model under set C
    at 1536 (4 leveled + 2 planes launches per step), the flagship cache
    under set D with two micro-steps per update at 8192 (2 leveled per
    update; without the eikonal loss), the flagship transient cache with the
    Gaussian pyramid at 2048 x 700 bins (1 leveled)."""
    from neural_radiance_caching_tpu_torch import flagship

    def material():
        config = flagship.material_config(batch_size=OPTIONS_MATERIAL_BATCH, **SET_C_CONFIG)
        return flagship.build_flagship_material_model(
            config, _set_c(flagship.flagship_material_params()), device=device), config

    def cache():
        config = flagship.cache_config(batch_size=OPTIONS_CACHE_BATCH, **SET_D_ACCUM_CONFIG)
        return flagship.build_flagship_cache_model(
            config, flagship.flagship_cache_params(), device=device), config

    def transient():
        config = flagship.transient_config(batch_size=OPTIONS_TRANSIENT_BATCH, **GAUSS_CONFIG)
        return flagship.build_flagship_transient_cache_model(
            config, flagship.flagship_transient_cache_params(), device=device), config

    run = functools.partial(_sampling_train_run, torch, device, seed, steps, smi)
    return dict(
        material=run(material, OPTIONS_MATERIAL_BATCH, _OPTIONS_SET_C_LAUNCHES,
                     "material options train (flagship material, set C)"),
        cache=run(cache, OPTIONS_CACHE_BATCH, _OPTIONS_ACCUM_LAUNCHES,
                  "material options train (flagship cache, set D with gradient accumulation)",
                  micro=2),
        transient=run(transient, OPTIONS_TRANSIENT_BATCH, _OPTIONS_TRANSIENT_LAUNCHES,
                      "material options train (flagship transient cache, Gaussian pyramid)",
                      views=(4, 64)))


# Phase 47: the SLF's remaining options, the environment map, the cache
# model's own resampling and the shaders' remaining fields
# (models/surface_light_field.py, nerf_model.py, nerf_shader.py,
# material_shader.py, material_model.py, shading.py). Set E on
# nero_ngp_yobo_bell's SLF: the points' integrated encoding, the sphere
# point, sorted distances with the point nudge (3 samples: past 3 JAX's nudge
# gather fills NaN, a reference gap), the roughness-scaled reflectance query
# and its density head. Set E': voxel-plane placement with the far-field
# point as the reflectance query. open_ngp_yobo_egg with the environment
# map on the cache model, its shader and the material shader (the config's
# own env_map_params; SLICE_ENV_INSIDE's env distance). The flagship cache with
# its own resampling of primary rays under resample_argmax.
SLICE_SET_E = dict(use_points=True, use_points_ide=True, use_sphere_points=True,
                   sphere_radius=1.5, use_sorted_distances=True, use_point_offsets=True,
                   num_distance_samples=3, point_offset_bias=0.0, use_roughness=True,
                   roughness_scale=0.5, use_density_prediction=True)
SLICE_SET_E_PRIME = dict(use_voxel_grid=True, num_distance_samples=6, voxel_end=4.0,
                         use_far_field_points=True)
SLICE_ENV = ("NeRFModel.use_env_map = True", "NeRFMLP.use_env_map = True")
SLICE_SLF_STAGE = ("Trainer.stage = 'material_surface_light_field_light'",
                   "Trainer.resample = True", "Trainer.resample_render = True",
                   "MaterialMLP.use_env_map = True")
SLICE_MATERIAL_NARROW = (
    "LightMLP.num_components = 8", "LightMLP.net_width = 16", "LightMLP.bottleneck_width = 16",
    "MaterialMLP.net_width = 16", "MaterialMLP.bottleneck_width = 16",
    "MaterialMLP.cache_train_sampling_strategy = ((0, 0, 16), (1, 1, 16), (2, 2, 16))")
# The env-map steps' env distance: the config's own 0.5 equals its SLF's
# near plane, which leaves the SLF an empty range (no gradient reaches its
# grids, in JAX too, and a planted fault shows nowhere); 2.0 gives the SLF
# and its kernels a gradient. The SLF material stage's loss radius: the
# config's 0.5 takes in no surface point of synthetic_spheres (its central
# sphere's radius is 0.55), so no material output would take a gradient.
SLICE_ENV_INSIDE = ("Config.env_map_distance = 2.0",)
SLICE_LIVE_MATERIAL = ("Config.material_loss_radius = 10.0",
                       "Config.surface_light_field_loss_radius = 10.0")
# The narrow steps' reflectance grid under set E (64 rays x 16 samples x 3
# points) takes the planes kernel from this many points.
SLICE_PLANES_MIN = 2048
SLICE_RESAMPLE = dict(resample=True, num_resample=4, resample_argmax=True)
# The steady cache shader's active path (a point light, BRDF-net direct
# terms, C-channel indirect nets); the narrow step traces its shadow rays.
SLICE_STEADY_ACTIVE = ("NeRFMLP.use_active = True",)
SLICE_OCCLUSIONS = ("Config.use_occlusions = True",
                    "Config.occlusions_secondary_only = False")
SLICE_CACHE_BATCHES = (8192, 4096, 2048)
SLICE_MATERIAL_BATCHES = (1024, 512)
SLICE_RESAMPLE_BATCH = 8192
SLICE_WARMUP = 2
SLICE_STEPS = 2
# Each narrow reference: (scene, config file, stage bindings, kernel launches
# per step, the kernel the faults are planted in, the planes threshold,
# loss terms that must be present and nonzero).
SLICE_REFERENCES = (
    ("nero_bell set E", "configs/nero_ngp_yobo_bell.gin",
     TRAINER_CACHE_STAGE + NGP_NARROW, SLICE_SET_E, (), {"planes": 1}, "planes",
     SLICE_PLANES_MIN, ("data", "cache_data")),
    ("nero_bell set E'", "configs/nero_ngp_yobo_bell.gin",
     TRAINER_CACHE_STAGE + NGP_NARROW, SLICE_SET_E_PRIME, (), {"leveled": 1}, "leveled",
     None, ("data", "cache_data")),
    ("open_egg env map cache", "configs/open_ngp_yobo_egg.gin",
     TRAINER_CACHE_STAGE + NGP_NARROW + ("Config.far = 4.0",), {},
     SLICE_ENV + SLICE_ENV_INSIDE, {"leveled": 2}, "leveled", None, ("data", "cache_data")),
    ("ngp_yobo steady active cache", "configs/ngp_yobo.gin",
     TRAINER_CACHE_STAGE + NGP_NARROW, None, SLICE_STEADY_ACTIVE + SLICE_OCCLUSIONS,
     {}, "leveled", None, ("data", "cache_data")),
    ("open_egg env map SLF material", "configs/open_ngp_yobo_egg.gin",
     SLICE_SLF_STAGE + ("Trainer.sample_factor = 1",) + NGP_NARROW + SLICE_MATERIAL_NARROW
     + ("Config.far = 4.0",), {},
     SLICE_ENV + SLICE_ENV_INSIDE + SLICE_LIVE_MATERIAL, {"leveled": 8}, "leveled", None,
     ("cache_data", "data", "material_surface_light_field")),
)


def phase_slice_reference(torch, device, seed):
    """Phase 31's method (`_gpu_vs_cpu_step`) on SLICE_REFERENCES at
    NGP_NARROW's widths: every loss term and gradient leaf of one step, GPU
    against CPU, the limit bracketed by the CPU's noise floor and two faults
    planted in the planes (set E) or leveled kernel; every scatter call held
    against its plain version."""
    out = {}
    for label, config_file, stage, options, extra, launches, kind, planes_min, terms in \
            SLICE_REFERENCES:
        slf = () if options is None else (_narrow_slf_binding(config_file, options),)
        narrow = stage + slf + extra
        r = _gpu_vs_cpu_step(torch, device, seed, narrow, config_file, launches=launches,
                             terms=terms, fault_kind=kind, planes_min=planes_min)
        print(f"slice reference ({label}): Trainer, {config_file} at reference widths (batch "
              f"64, 16 samples per level), one step, the same weights, batch and draws, gpu vs "
              f"cpu: {_gpu_vs_cpu_text(r)}; the scatter calls against their plain version: "
              f"{_checked_text(r['checked'])}; kernel launches gpu={r['launches']} "
              f"cpu={r['cpu_launches']} {'ok' if r['ok'] else 'FAIL'}", flush=True)
        if not r["ok"]:
            raise AssertionError(f"the Trainer's GPU step disagrees with its CPU step ({label})")
        out[label] = {k: v for k, v in r.items()
                      if k not in ("ok", "checked", "cpu_launches", "grad_rel_l2_errs")}
    return out


def _slice_entry_run(torch, label, config_file, bindings, batches, seed, smi, tmp, warm=None):
    """`config_file` with `bindings` through the train_with_trainer entry
    point, in-process, at the largest of `batches` that fits:
    SLICE_WARMUP + SLICE_STEPS steps, the timed ones by host clock, the
    launch counts set to 0 before the run and read after it; then one step
    with every scatter call held against its plain version, whose launches
    the run's must equal per step (and which must launch, each kernel on
    some nonzero cotangent). No resume and no
    eval view: phases 20-32 hold both. Returns (readings, checkpoint)."""
    import gc
    import os

    from neural_radiance_caching_tpu_torch.engine import gin_config

    total, cut = SLICE_WARMUP + SLICE_STEPS, []
    for batch in batches:
        ckpt = os.path.join(tmp, f"slice_{label.replace(' ', '_')}_{batch}")
        common = TRAINER_BINDINGS + tuple(bindings) + (
            f"Config.batch_size = {batch}", f"Config.checkpoint_dir = '{ckpt}'",
            f"Config.early_exit_steps = {total}", f"Config.print_every = {total}",
            f"Config.jax_rng_seed = {20200823 + seed}", "Trainer.save_results = False")
        args = [f"--gin_configs={config_file}"] + [f"--gin_bindings={b}" for b in common]
        if warm is not None:
            args.append(f"--gin_bindings=Config.partial_checkpoint_dir = '{warm}'")
        try:
            run = _entry_point_run(torch, args, None, ckpt, SLICE_WARMUP, SLICE_STEPS,
                                   evaluate=False)
            break
        except torch.cuda.OutOfMemoryError as e:
            cut.append(_out_of_memory(torch, f"slice train ({label})", batch, e))
            del e
            gin_config.clear_config()
            gc.collect()
            torch.cuda.empty_cache()
    else:
        raise AssertionError(f"no batch of {batches} fits {label}")
    trainer = run["trainer"]
    calls, checked, stats = _checked_step(torch, trainer, {"leveled": 0, "planes": 0})
    per_step = {k: v for k, v in checked.items() if v}
    finite = _finite(run["losses"].values()) and bool(torch.isfinite(stats["loss"]))
    # Each kernel's check is void on zero cotangents: each must see some.
    live = {k: sum(c["ct_abs_max"] > 0 for c in calls if c["kind"].startswith(k))
            for k in per_step}
    ok = (finite and run["saved"] == total
          and run["launches"] == _launch_counts(**{k: n * total for k, n in per_step.items()})
          and len(calls) == sum(per_step.values()) and all(c["ok"] for c in calls)
          and all(live.values()))
    dt = run["step_s"]
    print(f"slice train ({label}): train_with_trainer {config_file}"
          f"{' warm-started from its cache stage' if warm else ''} "
          f"{_cut_text(batch, batches, cut)}, {SLICE_WARMUP} warmup + {SLICE_STEPS} timed "
          f"steps: step_ms={dt * 1e3:.2f} rays_per_s={batch / dt:.0f} on [{smi}]; peak "
          f"{run['peak_gib']:.2f} GiB; losses finite={finite}; kernel launches="
          f"{ {k: v for k, v in run['launches'].items() if v} } over {total} steps (per step "
          f"{per_step}, asserted: the checked step's); checked step "
          + "; ".join(f"{c['kind']} idx{list(c['shape'])} max_abs_err={c['max_abs_err']:.3e} "
                      f"|ct|max={c['ct_abs_max']:.3e} {'ok' if c['ok'] else 'FAIL'}"
                      for c in calls)
          + f"; calls with a nonzero cotangent by kernel {live} (each must be > 0); entry "
          f"point {run['wall']:.1f}s {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"slice train phase failed ({label})")
    out = dict(step_ms=dt * 1e3, rays_per_s=batch / dt, peak_gib=run["peak_gib"], batch=batch,
               cut=cut, steps=SLICE_STEPS, warmup=SLICE_WARMUP, launches_per_step=per_step,
               launches={k: run["launches"][k] for k in per_step}, entry_point_s=run["wall"],
               live_calls=live,
               max_abs_err=max((c["max_abs_err"] for c in calls), default=0.0))
    del trainer, run, stats
    gin_config.clear_config()
    gc.collect()
    torch.cuda.empty_cache()
    return out, ckpt


def phase_slice_train(torch, device, seed, smi, tmp):
    """Phase 47's full-width runs through the entry point: nero_bell's cache
    stage under set E and open_egg's with the environment map (the largest
    of 8192, 4096, 2048 that fits), open_egg's SLF material stage with the
    environment map at 1024 (or 512) warm-started from it, ngp_yobo's cache
    stage with the steady shader's active path (no kernel launch: its
    density normals take the plain encoder); then the flagship cache under
    its own resampling with resample_argmax at 8192."""
    from neural_radiance_caching_tpu_torch import flagship
    from neural_radiance_caching_tpu_torch.ops import hashgrid

    nero, open_egg = "configs/nero_ngp_yobo_bell.gin", "configs/open_ngp_yobo_egg.gin"
    runs = {}
    runs["nero_bell_set_e"], _ = _slice_entry_run(
        torch, "nero_bell set E", nero,
        TRAINER_CACHE_STAGE + (_narrow_slf_binding(nero, SLICE_SET_E, narrow=False),),
        SLICE_CACHE_BATCHES, seed, smi, tmp)
    points = runs["nero_bell_set_e"]["batch"] * NGP_FINAL_SAMPLES * 3
    kind = "planes" if hashgrid.use_planes_layout(points, "mean") else "leveled"
    env = TRAINER_CACHE_STAGE + ("Config.far = 4.0",) + SLICE_ENV + SLICE_ENV_INSIDE
    runs["open_egg_env_cache"], ckpt = _slice_entry_run(
        torch, "open_egg env map cache", open_egg, env, SLICE_CACHE_BATCHES, seed, smi, tmp)
    runs["open_egg_env_slf_material"], _ = _slice_entry_run(
        torch, "open_egg env map SLF material", open_egg,
        ("Config.far = 4.0",) + SLICE_ENV + SLICE_ENV_INSIDE + SLICE_LIVE_MATERIAL
        + SLICE_SLF_STAGE,
        SLICE_MATERIAL_BATCHES, seed, smi, tmp, warm=ckpt)

    runs["ngp_yobo_steady_active"], _ = _slice_entry_run(
        torch, "ngp_yobo steady active cache", "configs/ngp_yobo.gin",
        TRAINER_CACHE_STAGE + SLICE_STEADY_ACTIVE, SLICE_CACHE_BATCHES, seed, smi, tmp)

    def cache():
        config = flagship.cache_config(batch_size=SLICE_RESAMPLE_BATCH)
        return flagship.build_flagship_cache_model(
            config, dict(flagship.flagship_cache_params(), **SLICE_RESAMPLE),
            device=device), config

    runs["flagship_resample_argmax"] = _sampling_train_run(
        torch, device, seed, SLICE_STEPS, smi, cache, SLICE_RESAMPLE_BATCH,
        _launch_counts(leveled=1),
        "slice train (flagship cache, resample_argmax, 4 samples per ray)")
    expected = {"nero_bell_set_e": {kind: 1}, "ngp_yobo_steady_active": {},
                "open_egg_env_cache": _open_launches(runs["open_egg_env_cache"]["batch"])}
    for k, want in expected.items():
        if runs[k]["launches_per_step"] != want:
            raise AssertionError(f"{k}: launches per step {runs[k]['launches_per_step']}, "
                                 f"expected {want}")
    return runs


def _profile(torch, train_step, state, rng, batches, path, steps=3):
    """Device time by kernel over `steps` steps, as a table written to `path`."""
    import pathlib

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state, _ = train_step(rng, state, batches[i], 0.5)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    path.write_text(table + f"\nhost clock over the {steps} profiled steps: {wall_ms:.2f} ms\n")
    print(f"profile: top device ops over {steps} steps ({wall_ms:.2f} ms by host clock, "
          f"profiler on) written to {path}", flush=True)
    print("\n".join(table.splitlines()[:16]), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=5, help="timed cache train steps")
    parser.add_argument("--material-steps", type=int, default=10,
                        help="timed material train steps")
    parser.add_argument("--transient-steps", type=int, default=10,
                        help="timed transient train steps of each run (direct, dedup)")
    parser.add_argument("--transient-material-steps", type=int, default=10,
                        help="timed transient material train steps of each form (bench, trainer)")
    parser.add_argument("--trainer-steps", type=int, default=3,
                        help="timed steps of each run through the entry point (phases 20-38, "
                             "42-46)")
    parser.add_argument("--profile", metavar="FILE",
                        help="also profile train steps and write the op tables to FILE "
                             "(cache), and FILE with .material, .transient, "
                             ".transient_material or .trainer_material before its suffix")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    import concurrent.futures

    from neural_radiance_caching_tpu_torch.data import jpeg
    from neural_radiance_caching_tpu_torch.ops import scatter_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda"
    smi = _smi()
    print(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} nvidia-smi=[{smi}]", flush=True)

    t_start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jpeg_build = pool.submit(jpeg.build_library)
        lib_paths = scatter_cuda.build_library(verbose=True)
        jpeg_path = jpeg_build.result()
    scatter_cuda.load_library()
    print(f"build: {', '.join(p.name for p in lib_paths.values())} from csrc/ with nvcc (one per "
          f"source, in parallel), and beside them {jpeg_path.name} (the JPEG entropy decoder) "
          f"with the host C compiler, in {time.perf_counter() - t_start:.1f}s", flush=True)

    kernel = phase_kernel(torch, device, args.seed)
    planes = phase_kernel_planes(torch, device, args.seed)
    rows = phase_kernel_rows(torch, device, args.seed)
    phase_encoder(torch, device, args.seed)
    phase_encoder_planes(torch, device, args.seed)
    phase_reference(torch, device, args.seed)
    phase_material_reference(torch, device, args.seed)
    phase_transient_reference(torch, device, args.seed)
    cache_leveled, _ = phase_train(torch, device, args.seed, args.steps, smi, args.profile)
    material, _, material_err, planes_path = phase_material_train(
        torch, device, args.seed, args.material_steps, smi, args.profile)
    transient, capture = phase_transient_train(
        torch, device, args.seed, args.transient_steps, smi, args.profile)
    skip = phase_kernel_skip(torch, device, capture)
    leveled_path = phase_kernel_path(
        "leveled", capture, MATERIAL_LEVELS,
        "transient path's own updates (camera-ray samples of one checked step)")
    del capture
    phase_eval_reference(torch, device, args.seed)
    gate = phase_gate(torch, device, args.seed, smi)
    eval_render = phase_eval_render(torch, device, args.seed, smi)
    tmat_reference = phase_transient_material_reference(torch, device, args.seed)
    tmat = phase_transient_material_train(torch, device, args.seed, args.transient_material_steps,
                                          smi, args.profile)
    tmat_launches = sum(r["launches"] for r in tmat.values())
    trainer_reference = phase_trainer_reference(torch, device, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        trainer_train, cache_ckpt = phase_trainer_train(torch, device, args.seed,
                                                        args.trainer_steps, smi, tmp)
        trainer_material_reference = phase_trainer_material_reference(torch, device, args.seed)
        trainer_material = phase_trainer_material_train(
            torch, device, args.seed, args.trainer_steps, smi, tmp, cache_ckpt,
            args.profile)
        trainer_transient_reference = phase_trainer_transient_reference(torch, device, args.seed)
        trainer_transient, transient_ckpt = phase_trainer_transient_train(
            torch, device, args.seed, args.trainer_steps, smi, tmp)
        trainer_tmat_reference = phase_trainer_transient_material_reference(torch, device,
                                                                            args.seed)
        trainer_tmat = phase_trainer_transient_material_train(
            torch, device, args.seed, args.trainer_steps, smi, tmp, transient_ckpt)
        trainer_slf_reference = phase_trainer_slf_reference(torch, device, args.seed)
        trainer_slf = phase_trainer_slf_train(torch, device, args.seed, args.trainer_steps, smi,
                                              tmp, cache_ckpt)
        invprop_reference = phase_trainer_invprop_reference(torch, device, args.seed)
        invprop = phase_trainer_invprop_train(torch, device, args.seed, args.trainer_steps, smi,
                                              tmp)
        baseline_reference = phase_trainer_baseline_reference(torch, device, args.seed)
        baseline, baseline_paths = phase_trainer_baseline_train(
            torch, device, args.seed, args.trainer_steps, smi, tmp)
        disk_reference = phase_disk_reference(torch, device, args.seed, tmp)
        disk = phase_disk_train(torch, device, args.seed, args.trainer_steps, smi, tmp)
        transient_disk_reference = phase_transient_disk_reference(torch, device, args.seed, tmp)
        transient_disk = phase_transient_disk_train(torch, device, args.seed, args.trainer_steps,
                                                    smi, tmp)
        real_reference = phase_real_disk_reference(torch, device, args.seed, tmp)
        real = phase_real_disk_train(torch, device, args.seed, args.trainer_steps, smi, tmp)
        eval_extras = phase_eval_extras(torch, device, args.seed, smi, tmp)
        data_parallel = phase_data_parallel(torch, device, args.seed, smi, tmp)
        colmap_reference = phase_colmap_reference(torch, device, args.seed, tmp)
        colmap = phase_colmap_train(torch, device, args.seed, smi, tmp)
        multi_reference = phase_multi_illum_reference(torch, device, args.seed, tmp)
        multi = phase_multi_illum_train(torch, device, args.seed, args.trainer_steps, smi, tmp,
                                        real["written"])
        options_reference = phase_options_reference(torch, device, args.seed)
        options = phase_options_train(torch, device, args.seed, args.trainer_steps, smi, tmp)
    sampling_reference = phase_sampling_reference(torch, device, args.seed)
    sampling_kernels = phase_sampling_kernels(torch, device, args.seed)
    sampling = phase_sampling_train(torch, device, args.seed, args.trainer_steps, smi)
    material_options_functions = phase_material_options_functions(torch, device, args.seed)
    material_options_reference = phase_material_options_reference(torch, device, args.seed)
    material_options = phase_material_options_train(torch, device, args.seed, args.trainer_steps,
                                                    smi)
    t_slice = time.perf_counter()
    slice_reference = phase_slice_reference(torch, device, args.seed)
    with tempfile.TemporaryDirectory() as slice_tmp:
        slice_runs = phase_slice_train(torch, device, args.seed, smi, slice_tmp)
    print(f"phase 47 done in {time.perf_counter() - t_slice:.1f}s", flush=True)
    print(f"phases done in {time.perf_counter() - t_start:.1f}s, build included", flush=True)

    csrc = "neural_radiance_caching_tpu_torch/csrc"
    replaces = "neural_radiance_caching_tpu/ops/scatter_tpu.py"
    timing = ("ms, plain_ms, library_ms: medians of 11 calls by CUDA events, wrapper included; "
              "library_ms is one index_add_ of the update rows (for a weighted scatter, the "
              "products formed beforehand); camera_ray_*, per_level_*, path_* (the inputs "
              "one train step gave the kernel: planes from the material path, leveled from "
              "the transient path) and the rows kernel's undedup_* (its camera-ray updates "
              "before the dedup scan) are kernel and index_add_ timed in 2 alternating turns, "
              "their *_plain_ms medians of 11 after; "
              "host_ms: host time of one call without a sync; "
              "bound_ms from the card's published HBM rate (3.35 TB/s) and float32 rate "
              "(67 TFLOP/s), each input read once and the output written once")
    leveled_launches = {"cache_train": cache_leveled, "material_train": material["leveled"],
                        "transient_train": transient["direct"]["launches"],
                        "transient_train_dedup": 0, "gate": gate["launches"], "eval_render": 0,
                        "transient_material": tmat_launches,
                        "trainer_train": trainer_train["launches"],
                        "trainer_material_train": trainer_material["launches"],
                        "trainer_transient_train": trainer_transient["launches"],
                        "trainer_transient_occlusions": trainer_transient["occlusions"][
                            "launches"]}
    tmat_paths = {f"trainer_{stage}": int(r["launches"]["leveled"])
                  for stage, r in trainer_tmat.items()}
    leveled_launches.update(tmat_paths)
    slf_paths = {"trainer_slf_reference": trainer_slf_reference["launches"],
                 "trainer_slf_train": trainer_slf["launches"],
                 "trainer_slf_cache_side": trainer_slf["cache_side"]["launches"]}
    leveled_launches.update(slf_paths)
    invprop_paths = {**{f"trainer_invprop_reference_{scene}":
                        invprop_reference[scene]["launches"]["leveled"]
                        for scene in INVPROP_SCENES},
                     **{f"trainer_{run}": r["launches"] for run, r in invprop.items()}}
    leveled_launches.update(invprop_paths)
    baseline_leveled = {
        **{f"trainer_baseline_reference_{scene}": baseline_reference[scene]["launches"]["leveled"]
           for scene in BASELINE_SCENES},
        **{f"trainer_{run}": r["launches_by_kernel"]["leveled"] for run, r in baseline.items()}}
    leveled_launches.update(baseline_leveled)
    baseline_planes = {f"trainer_{run}": r["launches_by_kernel"].get("planes", 0)
                       for run, r in baseline.items()}
    disk_runs = {run: r for run, r in disk.items() if run not in ("written", "hotdog_vis_only")}
    disk_leveled = {
        **{f"trainer_disk_reference_{scene}": disk_reference[scene]["launches"]["leveled"]
           for scene in DISK_SCENES},
        **{f"trainer_disk_{run}": r["launches_by_kernel"]["leveled"]
           for run, r in disk_runs.items()}}
    leveled_launches.update(disk_leveled)
    disk_planes = {f"trainer_disk_{run}": r["launches_by_kernel"]["planes"]
                   for run, r in disk_runs.items()}
    transient_disk_runs = {run: r for run, r in transient_disk.items()
                           if run not in ("written", "cornell_vis_only")}
    transient_disk_leveled = {
        **{f"trainer_transient_disk_reference_{scene}": transient_disk_reference[scene][
            "launches"]["leveled"] for scene in TRANSIENT_DISK_SCENES},
        **{f"trainer_transient_disk_{run}": r["launches"]
           for run, r in transient_disk_runs.items()},
        "trainer_transient_disk_cornell_vis_only": 0}
    leveled_launches.update(transient_disk_leveled)
    real_runs = {run: r for run, r in real.items() if run != "written"}
    real_leveled = {
        **{f"trainer_real_disk_reference_{scene}": real_reference[scene]["launches"]["leveled"]
           for scene in REAL_SCENES},
        **{f"trainer_real_disk_{run}": r["launches_by_kernel"]["leveled"]
           for run, r in real_runs.items()}}
    leveled_launches.update(real_leveled)
    dp_leveled = {f"data_parallel_{stage}_rank{rank}": n for stage in DP_STAGES
                  for rank, n in enumerate(data_parallel[stage]["launches"])}
    leveled_launches.update(dp_leveled)
    colmap_runs = {run: r for run, r in colmap.items() if run not in ("written", "flagship")}
    colmap_leveled = {"colmap_reference": colmap_reference["launches"],
                      **{f"colmap_train_{run}": r["launches_by_kernel"]["leveled"]
                         for run, r in colmap_runs.items()},
                      "colmap_flagship": colmap["flagship"]["launches"]}
    leveled_launches.update(colmap_leveled)
    multi_runs = {run: r for run, r in multi.items() if run != "written"}
    multi_leveled = {"multi_illum_reference": multi_reference["launches"]["leveled"],
                     **{f"multi_illum_{run}": r["launches_by_kernel"]["leveled"]
                        for run, r in multi_runs.items()}}
    leveled_launches.update(multi_leveled)
    options_leveled = {"options_reference": options_reference["launches"],
                       "options_patches": options["patches"]["launches"],
                       "options_mesh": options["mesh"]["launches"]}
    leveled_launches.update(options_leveled)
    sampling_leveled = {"sampling_reference": sampling_reference["launches"]["leveled"],
                        "sampling_concat_encoder": 1, "sampling_mean_encoder": 0,
                        "sampling_cache": sampling["cache"]["launches"].get("leveled", 0),
                        "sampling_material": sampling["material"]["launches"].get("leveled", 0)}
    leveled_launches.update(sampling_leveled)
    material_options_leveled = {
        "material_options_reference": material_options_reference["launches"]["leveled"],
        **{f"material_options_{run}": r["launches"].get("leveled", 0)
           for run, r in material_options.items()}}
    leveled_launches.update(material_options_leveled)
    slice_leveled = {**{f"slice_reference_{k}": r["launches"].get("leveled", 0)
                        for k, r in slice_reference.items()},
                     **{f"slice_{k}": r["launches"].get("leveled", 0)
                        for k, r in slice_runs.items()}}
    leveled_launches.update(slice_leveled)
    slice_planes = {**{f"slice_reference_{k}": r["launches"].get("planes", 0)
                       for k, r in slice_reference.items()},
                    **{f"slice_{k}": r["launches"].get("planes", 0)
                       for k, r in slice_runs.items()}}
    sampling_planes = {"sampling_reference": sampling_reference["launches"]["planes"],
                       "sampling_concat_encoder": 0, "sampling_mean_encoder": 1,
                       "sampling_cache": sampling["cache"]["launches"].get("planes", 0),
                       "sampling_material": sampling["material"]["launches"].get("planes", 0)}
    material_options_planes = {
        "material_options_reference": material_options_reference["launches"]["planes"],
        **{f"material_options_{run}": r["launches"].get("planes", 0)
           for run, r in material_options.items()}}
    real_planes = {f"trainer_real_disk_{run}": r["launches_by_kernel"]["planes"]
                   for run, r in real_runs.items()}
    multi_planes = {f"multi_illum_{run}": r["launches_by_kernel"]["planes"]
                    for run, r in multi_runs.items()}
    other_paths = {"trainer_transient_train": 0, "trainer_transient_occlusions": 0,
                   **{k: 0 for k in tmat_paths}, **{k: 0 for k in slf_paths},
                   **{k: 0 for k in invprop_paths}, **{k: 0 for k in baseline_leveled},
                   **{k: 0 for k in disk_leveled}, **{k: 0 for k in transient_disk_leveled},
                   **{k: 0 for k in real_leveled}, **{k: 0 for k in dp_leveled},
                   **{k: 0 for k in colmap_leveled}, **{k: 0 for k in multi_leveled},
                   **{k: 0 for k in options_leveled}, **{k: 0 for k in sampling_leveled},
                   **{k: 0 for k in material_options_leveled},
                   **{k: 0 for k in slice_leveled}}
    print(json.dumps({"kernels": [{
        "name": "scatter_add_weighted_leveled",
        "route": "cuda",
        "source": f"{csrc}/scatter_weighted.cu",
        "replaces": f"{replaces}:243",
        "launches": sum(leveled_launches.values()),
        "launches_by_path": leveled_launches,
        "max_abs_err": max(kernel["max_abs_err"], material_err["leveled"],
                           transient["direct"]["max_abs_err"],
                           *(r["max_abs_err"] for r in tmat.values()),
                           trainer_transient["occlusions"]["max_abs_err"],
                           *(r["max_abs_err"] for r in trainer_tmat.values()),
                           *(r["max_abs_err"] for r in trainer_tmat_reference.values()),
                           trainer_slf_reference["max_abs_err"],
                           *(invprop_reference[scene]["max_abs_err"] for scene in INVPROP_SCENES),
                           *(r["max_abs_err"] for r in invprop.values()),
                           *(baseline_reference[scene]["max_abs_err"]
                             for scene in BASELINE_SCENES),
                           *(r["max_abs_err_by_kernel"]["leveled"] for r in baseline.values()),
                           *(disk_reference[scene]["max_abs_err"] for scene in DISK_SCENES),
                           *(r["max_abs_err_by_kernel"].get("leveled", 0.0)
                             for r in disk_runs.values()),
                           *(transient_disk_reference[scene]["max_abs_err"]
                             for scene in TRANSIENT_DISK_SCENES),
                           *(r["max_abs_err"] for r in transient_disk_runs.values()),
                           *(real_reference[scene]["max_abs_err"] for scene in REAL_SCENES),
                           *(r["max_abs_err_by_kernel"].get("leveled", 0.0)
                             for r in real_runs.values()),
                           *(data_parallel[stage]["max_abs_err"] for stage in DP_STAGES),
                           colmap["flagship"]["max_abs_err"], multi_reference["max_abs_err"],
                           *(r["max_abs_err_by_kernel"].get("leveled", 0.0)
                             for r in multi_runs.values()),
                           options_reference["max_abs_err"], options["patches"]["max_abs_err"],
                           options["mesh"]["max_abs_err"], sampling_reference["max_abs_err"],
                           sampling_kernels["concat"]["max_abs_err"],
                           sampling["material"]["max_abs_err_by_kernel"]["leveled"],
                           material_options_reference["max_abs_err"],
                           *(r["max_abs_err_by_kernel"]["leveled"]
                             for r in material_options.values()),
                           *(r["max_abs_err"] for r in slice_reference.values()),
                           *(r["max_abs_err"] for r in slice_runs.values())),
        "max_abs_err_by_shape": {"cache": kernel["max_abs_err"],
                                 "material_path": material_err["leveled"],
                                 "transient_path": transient["direct"]["max_abs_err"],
                                 "transient_material_path": max(
                                     r["max_abs_err"] for r in tmat.values()),
                                 "planes_shape": planes["leveled_max_abs_err"],
                                 "trainer_transient_path": trainer_transient["occlusions"][
                                     "max_abs_err"],
                                 **{f"trainer_{stage}_path": r["max_abs_err"]
                                    for stage, r in trainer_tmat.items()},
                                 "trainer_slf_reference_path": trainer_slf_reference[
                                     "max_abs_err"],
                                 **{f"trainer_invprop_reference_{scene}_path": invprop_reference[
                                     scene]["max_abs_err"] for scene in INVPROP_SCENES},
                                 **{f"trainer_{run}_path": r["max_abs_err"]
                                    for run, r in invprop.items()},
                                 **{f"trainer_baseline_reference_{scene}_path":
                                    baseline_reference[scene]["max_abs_err"]
                                    for scene in BASELINE_SCENES},
                                 **{f"trainer_{run}_path": r["max_abs_err_by_kernel"]["leveled"]
                                    for run, r in baseline.items()},
                                 **{f"trainer_disk_reference_{scene}_path":
                                    disk_reference[scene]["max_abs_err"]
                                    for scene in DISK_SCENES
                                    if disk_reference[scene]["launches"]["leveled"]},
                                 **{f"trainer_disk_{run}_path": r["max_abs_err_by_kernel"][
                                     "leveled"] for run, r in disk_runs.items()
                                    if "leveled" in r["max_abs_err_by_kernel"]},
                                 **{f"trainer_transient_disk_reference_{scene}_path":
                                    transient_disk_reference[scene]["max_abs_err"]
                                    for scene in TRANSIENT_DISK_SCENES},
                                 **{f"trainer_transient_disk_{run}_path": r["max_abs_err"]
                                    for run, r in transient_disk_runs.items()},
                                 **{f"trainer_real_disk_reference_{scene}_path":
                                    real_reference[scene]["max_abs_err"]
                                    for scene in REAL_SCENES},
                                 **{f"trainer_real_disk_{run}_path": r["max_abs_err_by_kernel"][
                                     "leveled"] for run, r in real_runs.items()
                                    if "leveled" in r["max_abs_err_by_kernel"]},
                                 **{f"data_parallel_{stage}_path": data_parallel[stage][
                                     "max_abs_err"] for stage in DP_STAGES},
                                 "colmap_flagship_path": colmap["flagship"]["max_abs_err"],
                                 "multi_illum_reference_path": multi_reference["max_abs_err"],
                                 **{f"multi_illum_{run}_path": r["max_abs_err_by_kernel"][
                                     "leveled"] for run, r in multi_runs.items()
                                    if "leveled" in r["max_abs_err_by_kernel"]},
                                 "options_reference_path": options_reference["max_abs_err"],
                                 "options_patches_path": options["patches"]["max_abs_err"],
                                 "options_mesh_path": options["mesh"]["max_abs_err"],
                                 "sampling_reference_path": sampling_reference["max_abs_err"],
                                 "sampling_concat_encoder": sampling_kernels["concat"][
                                     "max_abs_err"],
                                 "sampling_material_path": sampling["material"][
                                     "max_abs_err_by_kernel"]["leveled"],
                                 "material_options_reference_path": material_options_reference[
                                     "max_abs_err"],
                                 **{f"material_options_{run}_path": r["max_abs_err_by_kernel"][
                                     "leveled"] for run, r in material_options.items()},
                                 **{f"slice_reference_{k}_path": r["max_abs_err"]
                                    for k, r in slice_reference.items()},
                                 **{f"slice_{k}_path": r["max_abs_err"]
                                    for k, r in slice_runs.items()}},
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "library_ms": kernel["library_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"],
        "transient_shape_ms": skip["direct_route_ms"],
        "camera_ray_ms": kernel["camera_ray_ms"],
        "camera_ray_library_ms": kernel["camera_ray_library_ms"],
        "camera_ray_plain_ms": kernel["camera_ray_plain_ms"],
        **leveled_path,
        "trainer_transient_path": trainer_transient["path"],
        **{f"trainer_{stage}_path": r["paths"]["leveled"] for stage, r in trainer_tmat.items()},
        **({"trainer_open_slf_path": baseline_paths["open_leveled"]}
           if "open_leveled" in baseline_paths else {}),
        **{f"sampling_concat_{k}": v for k, v in sampling_kernels["concat"].items()
           if k.startswith("path_")},
        "sampling_concat_updates": sampling_kernels["concat"]["updates"],
    }, {
        "name": "scatter_add_weighted_leveled_skip_zero_w",
        "route": "cuda",
        "source": f"{csrc}/scatter_weighted.cu",
        "replaces": f"{replaces}:229",
        "launches": transient["dedup"]["launches"],
        "launches_by_path": {"cache_train": 0, "material_train": 0, "transient_train": 0,
                             "transient_train_dedup": transient["dedup"]["launches"], "gate": 0,
                             "eval_render": 0, "transient_material": 0, "trainer_train": 0,
                             "trainer_material_train": 0, **other_paths},
        "max_abs_err": max(skip["max_abs_err"], transient["dedup"]["max_abs_err"]),
        "max_abs_err_by_shape": {"transient_dedup_stream": skip["max_abs_err"],
                                 "transient_path": transient["dedup"]["max_abs_err"]},
        "ms": skip["ms"],
        "plain_ms": skip["plain_ms"],
        "library_ms": skip["library_ms"],
        "bound_ms": skip["bound_ms"],
        "bound_by": skip["bound_by"],
        "zero_weight_share": skip["zero_weight_share"],
        "dedup_route_ms": skip["dedup_route_ms"],
        "direct_route_ms": skip["direct_route_ms"],
    }, {
        "name": "scatter_add_weighted_planes",
        "route": "cuda",
        "source": f"{csrc}/scatter_weighted.cu",
        "replaces": f"{replaces}:364",
        "launches": material["planes"] + sum(baseline_planes.values())
        + sum(disk_planes.values()) + sum(real_planes.values()) + sum(multi_planes.values())
        + sum(sampling_planes.values()) + sum(material_options_planes.values())
        + sum(slice_planes.values()),
        "launches_by_path": {"cache_train": 0, "material_train": material["planes"],
                             "transient_train": 0, "transient_train_dedup": 0, "gate": 0,
                             "eval_render": 0, "transient_material": 0, "trainer_train": 0,
                             "trainer_material_train": 0, **other_paths, **baseline_planes,
                             **disk_planes, **real_planes, **multi_planes, **sampling_planes,
                             **material_options_planes, **slice_planes},
        "max_abs_err": max(planes["max_abs_err"], material_err["planes"],
                           *(r["max_abs_err_by_kernel"].get("planes", 0.0)
                             for r in [*baseline.values(), *disk_runs.values(),
                                       *real_runs.values(), *multi_runs.values()]),
                           sampling_kernels["mean"]["max_abs_err"],
                           *(r["max_abs_err_by_kernel"]["planes"] for r in sampling.values()),
                           material_options["material"]["max_abs_err_by_kernel"]["planes"]),
        "max_abs_err_by_shape": {"planes_shape": planes["max_abs_err"],
                                 "material_path": material_err["planes"],
                                 **{f"trainer_{run}_path": r["max_abs_err_by_kernel"]["planes"]
                                    for run, r in baseline.items()
                                    if "planes" in r["max_abs_err_by_kernel"]},
                                 **{f"trainer_disk_{run}_path": r["max_abs_err_by_kernel"][
                                     "planes"] for run, r in disk_runs.items()
                                    if "planes" in r["max_abs_err_by_kernel"]},
                                 **{f"trainer_real_disk_{run}_path": r["max_abs_err_by_kernel"][
                                     "planes"] for run, r in real_runs.items()
                                    if "planes" in r["max_abs_err_by_kernel"]},
                                 **{f"multi_illum_{run}_path": r["max_abs_err_by_kernel"][
                                     "planes"] for run, r in multi_runs.items()
                                    if "planes" in r["max_abs_err_by_kernel"]},
                                 "sampling_mean_encoder": sampling_kernels["mean"]["max_abs_err"],
                                 **{f"sampling_{run}_path": r["max_abs_err_by_kernel"]["planes"]
                                    for run, r in sampling.items()},
                                 "material_options_material_path": material_options["material"][
                                     "max_abs_err_by_kernel"]["planes"]},
        "ms": planes["ms"],
        "plain_ms": planes["plain_ms"],
        "library_ms": planes["library_ms"],
        "bound_ms": planes["bound_ms"],
        "bound_by": planes["bound_by"],
        "leveled_same_updates_ms": planes["leveled_ms"],
        "per_level_ms": planes["per_level_ms"],
        "per_level_library_ms": planes["per_level_library_ms"],
        **planes_path,
        **({"trainer_open_reflectance_path": baseline_paths["open_planes"]}
           if "open_planes" in baseline_paths else {}),
        **{f"sampling_mean_{k}": v for k, v in sampling_kernels["mean"].items()
           if k.startswith("path_")},
        "sampling_mean_updates": sampling_kernels["mean"]["updates"],
    }, {
        "name": "scatter_add_rows_leveled",
        "route": "cuda",
        "source": f"{csrc}/scatter_weighted.cu",
        "replaces": f"{replaces}:79",
        "launches": rows["launches"],
        "launches_by_path": {"rows_kernel_phase": rows["launches"], "cache_train": 0,
                             "material_train": 0, "transient_train": 0,
                             "transient_train_dedup": 0, "gate": 0, "eval_render": 0,
                             "transient_material": 0, "trainer_train": 0,
                             "trainer_material_train": 0, **other_paths},
        **{k: v for k, v in rows.items() if k != "launches"},
    }], "timing": timing, "transient_train": {
        name: {k: v for k, v in r.items() if k != "max_abs_err"}
        for name, r in transient.items()}}), flush=True)
    print(json.dumps({"eval": {"gate": gate, "render": eval_render, "extras": eval_extras,
                               "device": smi}}), flush=True)
    print(json.dumps({"transient_material": {
        "train": {name: {k: v for k, v in r.items() if k != "max_abs_err"}
                  for name, r in tmat.items()},
        "reference": tmat_reference, "eval_render": eval_render["transient_material"],
        "leveled_launches_per_step": _TRAINER_TRANSIENT_MATERIAL_LAUNCHES_PER_STEP["leveled"],
        "device": smi}}), flush=True)
    print(json.dumps({"trainer": {
        "train": trainer_train, "reference": trainer_reference,
        "material_train": trainer_material, "material_reference": trainer_material_reference,
        "material_reference_leveled_launches_per_step": _TRAINER_MATERIAL_LAUNCHES_PER_STEP,
        "transient_train": {k: v for k, v in trainer_transient.items() if k != "path"},
        "transient_reference": trainer_transient_reference,
        "transient_material_train": {stage: {k: v for k, v in r.items() if k != "paths"}
                                     for stage, r in trainer_tmat.items()},
        "transient_material_reference": trainer_tmat_reference,
        "slf_train": trainer_slf, "slf_reference": trainer_slf_reference,
        "slf_reference_leveled_launches_per_step": _TRAINER_SLF_LAUNCHES_PER_STEP["leveled"],
        "invprop_train": invprop, "invprop_reference": invprop_reference,
        "baseline_train": baseline, "baseline_reference": baseline_reference,
        "disk_train": disk, "disk_reference": disk_reference,
        "transient_disk_train": transient_disk,
        "transient_disk_reference": transient_disk_reference,
        "real_disk_train": real, "real_disk_reference": real_reference,
        "data_parallel": data_parallel, "colmap_reference": colmap_reference,
        "colmap_train": colmap, "multi_illum_reference": multi_reference,
        "multi_illum_train": multi, "options_reference": options_reference,
        "options_train": options, "sampling_reference": sampling_reference,
        "sampling_train": sampling,
        "material_options_functions": material_options_functions,
        "material_options_reference": material_options_reference,
        "material_options_train": material_options, "slice_reference": slice_reference,
        "slice_train": slice_runs, "device": smi}}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # report the failed phase; exit nonzero with no result line
        traceback.print_exc()
        sys.exit(1)
