"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. device: require CUDA, print the card's name and power limit;
  2. build: compile the port's CUDA kernels from csrc/ (nvcc, sm_90a);
  3. kernels against their plain torch versions on the card, at the main
     path's shapes: BVH4 traversal over ~1M rays of the helmet stand-in
     (camera rays of a 1080p frame at stride 2 plus incoherent rays from
     inside the scene), closest hit and any hit, then the BVH4 variants v5
     (multi-pop), v7 (sidecar) and v8 (leaf queue) on the same rays; the
     HDR gather over 2M indices beside its library call
     (torch.index_select). Times of all versions and the visit counts of
     the bounds are printed. traverse_bvh4 is also held equal to v7 (the
     same walk over the int32 sidecar) bit for bit on every ray and
     timed beside it in interleaved rounds (phase 6 does the same on the
     terrain), and v5's closest-hit t is held equal to traverse_bvh4's bit
     for bit on every ray (ids, u and v may differ only there: equal-t
     ties, counted), any-hit occlusion equal, both timed in interleaved
     rounds, and so is v8's; the build's registers and spills of the
     instances of the ten kernels on csrc/live_lanes.cuh (the nine that
     compact live lanes, traverse_bvh4.cu, traverse_lanes.cu,
     traverse_bvh4_multipop.cu, traverse_bvh2.cu, traverse_bvh16.cu,
     traverse_bvh4_sidecar.cu, traverse_bvh4_split.cu,
     traverse_bvh4_leafqueue.cu and traverse_bvh2_split.cu, and
     megakernel.cu) are printed and kept in the JSON line;
  4. main path: GltfRenderer(1920, 1080, spp=1, max_depth=5, device="cuda")
     renders the helmet stand-in under a procedural HDR sky through the
     user entry points (create_scene, create_hdr, on_render, image_linear,
     save_image): 2 warm-up and 4 timed frames (TIMED). The kernels' launch
     counters are zeroed just before and must have moved;
  5. correctness: a 96x64 frame on the card (kernels) against the same
     frame from the port's plain CPU path, which tests/test_torch_frame.py
     holds against the JAX reference, for the helmet, for each scene of
     phase 15 (game, suite, lit game, materials), for the foliage stand-in
     of phase 17 at 1,024 cards (its kernels meet the full-size tables in
     phase 17) and for the helmet over the shadow-catcher plane; then the
     viewer's frames (VIEWER_CHECKS): an animated brainstem frame with the
     guides (the guides, lum_moments, the image and image_denoised), two
     upscale-2 helmet frames (the TAAU history) and a sky and a wireframe
     preview of the helmet, ids equal on >= 99.9% of pixels and every
     other output within 1e-3 * (1 + |cpu|) on >= 99% of its pixels;
  6. large-scene kernels: the 1,059,968-triangle terrain scene
     (scenes.write_large_glb) with every kernel table built (shapes, bytes,
     build seconds and stack needs printed); on ~1M rays (camera rays of
     the 1080p frame at stride 2 plus incoherent rays from inside the
     scene) each of BVH2, BVH16, the lane walk, BVH4 and the BVH4 variants
     v5, v7 and v8 runs closest hit and any hit, timed with CUDA events,
     and is held against its plain version on a fixed subset of 65,536 of
     those rays: ids equal except on equal-t ties, t/u/v within 1e-5,
     occlusion equal, nothing dropped; the visit counts of the bounds are
     printed;
  7. the terrain scene through the entry points at the bench recipe
     (1920x1080, spp 1, depth 5, the synthetic HDR) once per kernel
     selection (VKGR_PRIMARY_KERNEL, VKGR_PACKET_KERNEL) = (v3, v9), (v2, v2),
     (v6, v6), (lane, lane_stream), (v5, v5), (v7, v7), (v3, v8), switched
     on one renderer (each run from frame index 0 on fresh accumulation,
     its tables built in its warm-up): 2 warm-up and 1 timed frame each,
     the launch counters zeroed just before; each
     run must move its own kernels' counters and no other traversal
     counter, and its frame 0 must agree with the (v3, v9) one at
     tests/test_torch_frame.py's thresholds with the same ray count;
 7b. main-path launch replay: one (v3, v9) 1080p frame of the helmet (HDR)
     and of the terrain through on_render, with ops.intersect.traverse_bvh4
     wrapped to record clones of the 8 ray components of each of its
     launches (10 a frame: closest and shadow per bounce); each launch is
     then run through traverse_bvh4 and through v7 (traverse_bvh4_sidecar,
     the same walk over the sidecar), held equal to v7 bit for bit on every
     lane, timed in interleaved rounds, and held
     against the plain version on a fixed subset of 16,384 lanes
     (REPLAY_SUBSET, dead lanes included); lanes, live lanes, ms of each,
     the bound and the frame sums are printed. Then the same frame under (lane, lane_stream),
     (v5, v5), (v2, v2), (v6, v6) and (v3, v8), recording traverse_lanes',
     traverse_bvh4_multipop's, traverse_bvh2's, traverse_bvh16's and
     traverse_bvh4_leafqueue's launches (v8 takes the 9 after bounce 0's
     closest hit): each timed, against its plain version on a fixed subset,
     with its bound, and v5's, v2's, v6's and v8's beside traverse_bvh4 on
     the same lanes (v5's and v8's closest-hit t bit for bit, ties
     counted, any-hit occlusion equal). The (v2, v2) frames' launches also
     go through v1 (traverse_bvh2_split, which walks the same binary tree
     in the same near-first order over the split tables; closest hit only)
     beside traverse_bvh2: on a closest-hit launch t equal bit for bit on
     every lane and the (rnode, tri) pair after resolution equal except on
     equal-t ties (the lanes that differ are counted), on an any-hit
     launch the occlusion equal; timed in interleaved rounds, held against
     v1's plain version on a fixed subset, with its bound;
  8. the megakernel A/B (ops/megakernel.py, the reference's
     tools/exp_mega.py): the 2,073,600 camera rays of the 1080p frame 0 on
     the helmet and on the terrain, numpy seeds, depths 1, 2 and 5;
     render_mega (one launch) and render_wavefront (one BVH4 launch per
     bounce + torch glue) timed with CUDA events, ms and Mrays/s (rays x
     depth / ms), their ratio and the bound printed; the counters are
     zeroed before the timed runs and read after them; mega is held against
     wavefront on every ray and against its plain version on a fixed subset
     of 65,536 rays, whose paths that ended at each bounce are printed (the
     megakernel's lanes refill by path);
  9. split-table kernels (the packet4 kernel traverse_bvh4_split and the v1
     kernel traverse_bvh2_split) through ops/intersect.intersect_rays_packet
     (wide=True, v2=False) on the probe rays of phases 3 and 6, on the
     helmet and on the terrain: closest hit timed (kernel alone and through
     the entry point), anyhit=True timed and equal to the closest hit on
     every ray, and each kernel held against its plain version on a fixed
     subset of 65,536 rays as in phase 6; visits, bound, stack need, table
     bytes and upload seconds printed;
 10. VKGR_TRAVERSAL=packet4 through the entry points at the bench recipe on
     the terrain and on the helmet (2 warm-up and 2 timed frames each):
     only traverse_bvh4_split's counter may move among the traversal
     kernels, and frame 0 must agree with the (v3, v9) frame 0 of phases 7
     and 4 at tests/test_torch_frame.py's thresholds with the same ray count.
     Then phase 7b's replay of packet4: one more frame with
     ops.intersect.traverse_bvh4_split wrapped to record its 10 launches
     (every one closest hit, the shadow segments too), each timed beside
     traverse_bvh4 on the same lanes (the lanes whose t differs counted),
     held against the plain version on a fixed subset of 65,536 lanes, with
     its bound;
 11. VKGR_TRAVERSAL=wavefront (the stackless walk in plain torch) on the
     helmet: a 480x270 frame 0 sizes the run (time scaled by pixel count),
     then 1 warm-up and 1 timed frame at the largest of 1920x1080, 960x540
     and 480x270 predicted under 10 s (when 480x270 is chosen, the sizing
     frame is the timed frame); no traversal kernel may launch, and frame 0
     must agree with a (v3, v9) frame 0 of the same size;
 12. probes (vk_gltf_renderer_tpu_torch/probes): probe_nodefetch at the TPU
     probe's sizes under all four variant names, then on random-cycle
     tables of the terrain's nodes4_fi size (11 MB, in L2) and of 268 MB
     (past L2), then each table with one warp per block and SM (the
     chain's latency alone); probe_visit variants a, b, c, d, e and q at the TPU probe's
     sizes; both with 1,024 visits a chain (PROBE_VISITS); each run equal
     to its plain version, ns per visit printed;
 13. the stream-copy and micro-op probes: probe_stream_dma for every TPU
     variant A-G x copy construct (ld, cp_async, tma) at the TPU probe's
     size (one stream, 48 pages), then at card scale (one stream per SM,
     256 pages each) on tables of 11 MB (in L2) and 268 MB (past L2), each
     run equal to its plain version and, in the regular page order, to
     index_select + sum (its library time); probe_uarch for all 8 micro-ops
     at 20,000 steps, each equal to its plain version run on CPU copies of
     the inputs; ms, us per page, GB/s, ns and SM cycles per step printed.
 14. front ends, the user's entry points on the card: headless.main on the
     helmet stand-in under the HDR at 1920x1080, 6 frames (5 timed), with
     VKGR_SETTINGS in the run's temp dir: its BENCHMARK_JSON must read 5
     frames, 9,218 triangles and Mrays/s > 0, its PNG must decode with
     utils/png.read_png, and traverse_bvh4 and gather_channels must have
     launched (their counters zeroed just before); `benchmark run` on a
     two-line cfg (helmet and terrain at 512x512, 4 frames) and `compare`
     of its CSV with itself, both rc 0; the bench entry
     (python -m vk_gltf_renderer_tpu_torch.bench_impl) as a child at its
     recipe with 3 timed frames a scene (VKGR_BENCH_FRAMES; the recipe's
     20 cut for the run's time), whose JSON line must read value > 0 with
     no error; and
     utils/profiler.profile_frames on the helmet and the terrain at 1080p
     (1 frame each, as every profile of the run: PROFILED_FRAMES), both tables printed.
 15. the material model and punctual lights: the game stand-in under the
     HDR and the game with a point, a spot and a directional light
     (scenes.make_lit_game_standin) at 1920x1080, the suite stand-in under
     the sky at 1024x1024, and scenes.make_materials_standin (every
     material family on a sphere, three lights) under the sky at
     1920x1080, spp 1, depth 5, through the entry points: 2 warm-up and 2
     timed frames each, ms/frame (mean, min, max), Mrays/s, the scene's
     triangles and table sizes, and the launches a frame of traverse_bvh4
     (closest and any hit apart, by counting the calls of
     ops.intersect.traverse_bvh4, held equal to the kernel's counter) and
     of gather_channels (which must launch under the HDR and only there);
     then utils/profiler.profile_frames on the suite (kernel ms and
     launches a frame, busy share, the largest kernels).
     Then the transmission march's launches of one 1080p frame of the game
     and of scenes.make_materials_standin (every material family on a
     sphere, three lights), recorded by wrapping
     ops.intersect.traverse_bvh4 as phase 7b does (the closest-hit
     launches with tmin 1e-4): each replayed through traverse_bvh4 and
     its plain version on every lane (t, rnode and tri bit for bit on
     every lane, u and v on every hit), timed, with its bound.
 16. animation and the device refit: (a) BASELINE config 5 through
     headless.main (scenes.make_brainstem, 1024x1024, --frames 20
     --ptSamples 1 --animate 30, the sky): its BENCHMARK_JSON line and
     ms/frame, traverse_bvh4 launched and gather_channels not, one host
     BVH build (the load's); then a renderer animating the same scene 20
     frames with sync_scene_changes timed between two synchronizes (the
     refit's ms a frame) and profiled apart from whole frames
     (utils/profiler.profile_frames and profile_refit: launches a frame,
     the refit's apart); (b) 3 animated 96x64 brainstem frames on the card
     against the port's CPU path at tests/test_torch_frame.py's
     thresholds, the skinned vertex table within 1e-5, and the helmet
     after set_variant(1), which refits (no host BVH build); (c) phase 6's
     terrain renderer (every table family built), one of its 64 instances
     lifted by a node edit (NODE_TRANSFORMS): sync_scene_changes timed
     (with the upload of the refit's tables, then the same edit again)
     and rebuild_device_scene on the same edit; on the refitted tables
     every traversal kernel (v3/v9, v7, v2, v6, v5, v8, lane, packet4,
     v1) against its plain walk on 16,384 probe rays (PLAIN_CHECK_RAYS; closest-hit t bit
     for bit, id ties counted, occlusion equal), every selection's frame 0 against the
     default's, and traverse_bvh4's hits on the refitted tree against the
     fresh build of the moved scene (ids equal on >= 0.999 of the probe
     rays, the rest within 1e-5 in t but for 1e-4 of the rays).
 17. alpha and the infinite plane: (a) scenes.make_foliage_standin at
     16,384 cards under the HDR at 1920x1080, spp 1, depth 5: the host
     classification's seconds (ops/omm.py, whole triangles and level-2
     cells; computed once a run and handed to every later renderer of the
     file), the rows culled and split, the virtual
     rows, world rows, table MB and each family's stack need against its
     kernel's capacity (all tables built); (b) one 1080p frame with
     ops.intersect.traverse_bvh4 recorded, its launches sorted into bounce
     traces, alpha re-trace rounds (the rejecting lanes, tmin 0) and
     shadow-march rounds (tmin 1e-4): each re-trace and march launch timed
     through traverse_bvh4 on all its lanes, and a fixed subset of up to
     8,192 lanes of each, all the launches of a kind in one call, held
     against the plain walk (t, rnode, tri bit for bit, u and v on hits;
     the walk's cost is its step count, so one call a kind), with each
     kind's bound; (c) every traversal kernel against its plain walk on
     the culled and split tables (phase 16c's checks on 65,536 of the
     probe rays); (d) 1080p frames under each acceleration level (2
     warm-up and 4 timed each, a depth cut for the run's time; one
     renderer each, frame indices from 0), ms/frame,
     Mrays/s, traverse_bvh4 launches a frame (the frame's profile is
     `python -m vk_gltf_renderer_tpu_torch.utils.profiler --scene
     foliage`), and the share of pixels within 2e-3 of subtri's image after as many
     frames (printed, not required:
     culling shifts which alpha round decides a BLEND surface, and rays
     that run out of rounds differ between levels, ROADMAP C); (e) the
     leaf material set from MASK to
     OPAQUE through sync_scene_changes: one host rebuild, timed, every
     source triangle back in the world; (f) headless.main on the helmet at
     1080p over the shadow-catcher plane at y -1.05 (6 frames, 5 timed).
 18. guides, denoise, TAAU, preview (what the viewer shows of a frame):
     (a) BASELINE config 5 (scenes.make_brainstem, animated) at 1024x1024,
     depth 5, with denoise_guides on: 2 warm-up and 4 timed frames, each
     on_render then image_denoised() (temporal), both timed between two
     synchronizes; every guide finite, spec_hitdist 65504 or below 1e4,
     spec_albedo 0 on miss pixels, the denoised image finite; (b) the
     helmet at 480x270 with its sphere moved by (0.3, 0, 0) through
     SceneEditor between two guided frames: first_pos - first_pos_prev
     within 1e-3 of the move on the sphere's pixels and of 0 on the other
     hit pixels; (c) headless.main --upscale 2 --size 1920 1080 on the
     helmet under the HDR (rendered at 960x540), 6 frames (5 timed): its
     record, its PNG and image_upscaled() [1080,1920,3] finite; (d)
     preview frames (render_system 1) of the helmet at 1920x1080 under the
     sky and the HDR, each without and with the wireframe: 1 warm-up and 3
     timed, ms/frame and the launches a frame of traverse_bvh4 (and of
     gather_channels, under the HDR only), after image_denoised() timed
     3 times on a guided 1080p helmet frame and profiled
     (utils/profiler.profile_denoise, 1 call; the sky preview too,
     profile_frames); build_ibl's ms (best of 3)
     per environment; (e) pick() at 16 fixed pixels equal to the port's
     CPU pick of the same scene and camera, one traverse_bvh4 launch each.
     The phase prints its seconds in a [time] line.
 19. the editor and the viewer: (a) edit_cli.main on the helmet stand-in
     with --device cuda: render at 1920x1080 (depth 3, the shell's), then
     after translating the helmet node, after its undo, and after `add
     cube` (then undone): every PNG written, the undone render equal to
     the first byte for byte, the moved and added renders different; ms
     per render (cmd_render whole and its frame), traverse_bvh4 launches
     of each render, and the launches of one such render recorded with
     record_launches on a renderer built as cmd_render builds it, equal;
     (b) viewer.main --size 1024 under the HDR with a key script (orbit,
     select the plate, grid, gizmo, :translate and :undo on the card,
     :gizmo pick on a pixel of the +X handle, denoised display, preview):
     the PNG written, the pick equal to the same keys' pick on a CPU
     viewer, ms and traverse_bvh4 / gather_channels launches of every
     key-frame (each launches traverse_bvh4 and, under the HDR,
     gather_channels), then grid_overlay and gizmo_overlay (each mode)
     timed on a 1024x1024 image on the card; (c) the same script at
     --size 96, depth 2, on the card and on the CPU: every frame's
     accumulation and first-hit ids through _require_agree, the preview
     shading with the card's IBL products on both, and those products
     against the CPU's build (the BRDF LUT required within 1e-4; the
     environment's products printed: their texel-edge lookups, ROADMAP
     C); (d) 6 1080p
     helmet frames under the HDR with GltfRenderer.adaptive =
     AdaptiveSampler(target_fps=10): the spp sequence, every value a
     bucket. `[editor]` and `[viewer]` lines, then a [time] line.
 20. textures and devices: (a) a seeded 2048x2048 texture
     (scenes.texture_image, the size of DamagedHelmet's maps) written as
     JPEG 4:2:0 q75 (the port's writer, Pillow's defaults), JPEG 4:4:4,
     JPEG progressive (spectral selection), DDS BGRA8, DDS BC1 and KTX2
     RGBA8 and zlib, and a 256x256 one as KTX2 ETC1S, UASTC and ASTC 4x4
     (the copied per-block Python decoders; 256x256 is a cut of the
     512x512 asked for, to keep the phase within its minute): each
     file's bytes, encode and decode host seconds (with the card's name
     and power limit, the decode rate, and for the block formats the
     microseconds a block and the 2048x2048 time that gives), the lossless
     ones equal to the source texel for texel, the lossy ones' PSNR; (b)
     the helmet (scenes.helmet_with_texture) at 1920x1080, spp 1, depth 5,
     under the HDR, with (a)'s 2048x2048 file as its base colour in PNG
     and each container but the three per-block ones, which take a
     128x128 image (a cut: their Python decoders would take about 45 s
     each at 2048x2048): the card holds the host's texel pool bit for bit;
     the load seconds, the ms of frame 0 and its traverse_bvh4 /
     gather_channels launches a frame; the lossless containers' frame 0
     equal to the PNG texture's bit for bit; each lossy container's card
     renderer, its scene kept, set to 96x64: frame 0 on the card against
     frame 0 on the CPU through parallel.render_mesh(r, ["cpu"]) (the
     plain versions on copies of the card's tables, held equal to the
     host's above), through _require_agree. (c) to (f) render the helmet
     with a 128x128 JPEG base colour: (c) headless --output x.jpg and
     x.png on the card at 1080p: the JPEG read back by the port's decoder, its PSNR against the
     PNG; (d) parallel.render_mesh over [cuda:0] * 2 and over every visible
     card, each two 1080p frames equal to on_render's bit for bit with
     equal rays, ms/frame; then AdaptiveSampler(10) under render_mesh and
     its spp; (e) two processes of parallel.multihost on the card (gloo,
     CUDA tensors), 540 rows each of the 1080p helmet: each shard equal to
     the process's own unsharded frame bit for bit, three adaptive frames
     with equal spp on both ranks (a 120 s timeout on each; a failed rank
     fails the phase); (f) probes.boundary on the helmet and the terrain
     (2,097,152 rays): kernel, wf/bounce, mega/bounce, boundary and
     residency gain at depths 1 and 2. `[textures]` and `[devices]` lines,
     then a [time] line.
 21. SBVH, seeding, batching, WebP (the helmet stand-in at 1920x1080,
     depth 5, under the synthetic HDR): (a) the helmet built under
     VKGR_BVH=sbvh (build seconds, references against triangles, table MB
     by family, each family's stack need against its kernel's capacity;
     its SBVH makes no spatial split), every kernel's closest hits on all
     the probe rays against the SAH tables' (t bit for bit, id ties
     counted); three 1080p SBVH frames and three SAH frames (the first a
     warm-up), frame 0 equal but at the printed tie pixels, ms/frame and
     the replayed frame's traverse_bvh4 ms of each; then
     scenes.make_sliver_soup at 1,000 triangles, whose SBVH duplicates
     references: the same table lines, every traversal kernel against its
     plain walk on its tables (phase 16c's checks on 8,192 of the probe
     rays, SBVH_CHECK_RAYS) and its closest hits on all the probe rays
     against the SAH tables'; 3 1080p soup frames (SOUP_FRAMES), each from
     one state unseeded and seeded on the SBVH tables and on the SAH
     tables, accumulations equal but at the tie pixels, with the seeds
     kept on a triangle that has several rows counted; and node 0 moved:
     the device refit of its SBVH tables against the CPU refit's,
     traverse_bvh4 against the plain walk on 8,192 rays (t, rnode, tri
     bit for bit); (b) on (a)'s helmet renderer, 6 seeded
     (VKGR_PRIMARY_SEED=1) and 6 unseeded 1080p frames, then a node edit
     and 2 more: accumulations equal but at the tie pixels (first-hit ids
     that differ in any frame), the seed's valid share, the primary
     launch's ms seeded and unseeded (CUDA events), and the foliage
     stand-in at 64 cards left unseeded; (c) spp 4 batched
     (VKGR_SPP_BATCH=1) and scan, 1 warm-up and 2 timed frames each:
     ms/frame, traverse_bvh4 / gather_channels launches a frame and peak
     device bytes; the batched 96x64 card frame against the whole-frame
     CPU path (_require_agree); (d) the committed WebP fixtures
     (tests/data/webp) decoded on the host, equal to the digests of
     Pillow's decode, with host ms, us a macroblock (lossy) or ns a pixel
     (lossless); the helmet with a 512x512 base colour as PNG, lossless
     WebP (equal to the PNG frame bit for bit) and the lossy fixture (96x64
     card against CPU); headless --output x.webp at 1080p read back equal
     to the x.png output. `[sbvh]`, `[seed]`, `[batch]`,
     `[webp]` lines, then [time] lines.
 22. Pillow's other formats (image I/O without Pillow, no kernel of its
     own): (a) every committed fixture of tests/data/images (BMP/DIB, TGA,
     GIF, TIFF with the libtiff codecs the port reads: CCITT, LZMA, ZSTD,
     old-style JPEG, CIELab, the floating-point predictor, YCbCr,
     ThunderScan, 12-bit; Netpbm, PSD (Lab too), SGI, PCX/DCX, ICO/CUR,
     QOI, Sun raster, PNG in every form, BLP (CMYK JPEG too), FTEX, XBM,
     XPM, MSP, IM (YCC, planar and bit-decoded too), EPS, IPTC, PIXAR,
     SPIDER, FITS, McIDAS, GBR, PhotoCD, FLI/FLC, XV thumbnails, IM
     Tools, ICNS (JPEG 2000 entries too), BUFR, GRIB, HDF5, MPEG, JPEG
     2000 codestreams and JP2 files, AVIF (lossless, lossy, CDEF and loop
     restoration), and the arithmetic, lossless,
     subsampled lossless and CMYK/YCCK JPEGs) decoded on the host, equal
     to the digest of Pillow's decode in digests.json, refused where
     Pillow refuses it; a 2048x2048 map of
     each format (ICO and CUR 256x256, an icon's largest size) made here
     (the port's writers; RLE, Deflate, PackBits, literal-code LZW,
     literal packets, one-byte runs, QOI_OP_RGB pixels, vertical stripes
     as CCITT rows, a vectorised lossless JPEG coder assembled with numpy,
     PNG with each filter (1024x1024) and a filter a row, palette, 16-bit and Adam7
     PNG, ZSTD strips tiled from the committed frame zstd_strip.zst, an
     old-style JPEG and a CIELab TIFF, BLP DXT1 and palette, FTEX DXT1,
     MSP RLE and IM; SPIDER, FITS raw and GZIP_1, McIDAS, GBR, FLI BRUN,
     IM Tools, IPTC, PIXAR and IM's YCC, RGB3 and 12-bit types, a 768x512
     PhotoCD, a 128x128 ICNS it32 with its mask) decoded, host seconds
     each, each read back equal where its pixels are known; (b) the helmet
     at 1080p with a 512x512,
     216-colour base colour as PNG and as BMP, TGA, TIFF (LZW, LZMA,
     ZSTD, old-style JPEG), GIF, PPM, PSD, SGI, PCX, QOI, Sun raster,
     palette, 16-bit and Adam7 PNG, palette BLP and IM, a 256x256 ICO, a
     bilevel Group 4 TIFF, a 2x2-subsampled lossless JPEG, a gray FITS, an
     FLC, a 768x512 PhotoCD and a 128x128 ICNS: each frame
     equal bit for bit to the frame of a PNG of the same pixels, with 10
     traverse_bvh4 and 16 gather_channels launches, its ms printed; (c)
     headless --output in every new suffix
     at 1080p, read back by the port equal to the PNG output (the GIF, of
     more than 256 colours, within its median cut: the share of pixels
     that differ and the largest channel error); (d) JPEG 2000: a committed
     2048x2048 lossy JP2 (about 0.5 bits a pixel) and a 512x512 lossless
     codestream decoded on the host, equal to Pillow's digests, host
     seconds each; the helmet at 1080p on the 2048x2048 map and on a PNG of
     its decoded pixels, and on a 128x128 ICNS icon of a JPEG 2000 entry
     and on a PNG of it: each pair equal bit for bit, with 10 traverse_bvh4
     and 16 gather_channels launches; (e) AVIF: the committed 512x512
     lossless map, 2048x2048 lossy map (Pillow's defaults: quality 75,
     speed 6, 4:2:0) and 2048x2048 map of CDEF and loop restoration (speed
     2, enable-cdef=1) decoded on the host (the AV1 decoder of
     native/av1_decode.cpp), each equal to Pillow's digest, host seconds
     (best of 3); the helmet at 1080p on each and on a PNG of its pixels,
     equal bit for bit, with 10 traverse_bvh4 and 16 gather_channels
     launches. (a) also holds
     that every AVIF form the port does not read yet (digests.json's
     "gaps") is refused. `[formats]` lines, then [time] lines.

Bounds (the least time the card could take for the same work, the larger
of bytes / 3.35 TB/s and FLOPs / 67 TFLOP/s, H100 SXM fp32 without tensor
cores): bytes = the distinct table rows the plain version touched on the
rays it walked (a lower bound for the full ray set) times their row bytes,
plus every ray's inputs and outputs; FLOPs = the plain version's visits
scaled to the full ray count, 24 per box test and 55 per triangle test
(plus 20 per ray and bounce of megakernel shading); a lane entry is a box
test or a triangle test, as its kind says. A replayed launch's
dead lanes (!(tmax >= 0)) move only their tmax and five outputs (24
bytes): their result does not depend on the rest (the same rule holds for
the lane walk, v5, v2 and v6). The split kernels'
leaf rows are the 64-byte rows of tris; a v1 leaf node reads only its
32-byte nodes_i row. The probes: the distinct rows
their chains read plus their inputs and outputs, and 8 FLOPs per lane and
step (node fetch) or 24 per lane and box test (visit). The stream probe:
the distinct pages read plus the output, and one add per element and page
(two in the data-dependent order, its sum). The micro-op probe: its
[8,128] input and output plus the distinct table words (rows of 128 for
dynslice128) it reads, and its float ops per element and step
(UARCH_FLOPS). Plain times include that visit counting.

Prints one JSON line of per-kernel numbers, then the card's name and power
limit, then the contract line {"ok": true, "device": {...}} last. Exits
nonzero without CUDA or outside the repository.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from vk_gltf_renderer_tpu_torch import scenes as tscenes  # noqa: E402
from vk_gltf_renderer_tpu_torch.bench_impl import gpu_line  # noqa: E402
from vk_gltf_renderer_tpu_torch.ops import jpeg  # noqa: E402
from vk_gltf_renderer_tpu_torch.probes import device_ms  # noqa: E402
from vk_gltf_renderer_tpu_torch.utils.png import encode_png  # noqa: E402

FRAME_W, FRAME_H, SPP, DEPTH = 1920, 1080, 1, 5
WARMUP, TIMED = 2, 4  # phase 4's helmet frames (4 timed: a cut that keeps the script within its time)
# timed frames cut for the run's time: phase 7's per kernel selection, phase 10's per scene
TERRAIN_TIMED, PACKET4_TIMED = 1, 2
BENCH_CHILD_FRAMES = 3  # phase 14's bench_impl child: its timed frames a scene (a cut of the recipe's 20)
PROFILED_FRAMES = 1  # frames (or calls) each profile of the run covers (2 before, cut for the run's time)
PROBE_VISITS = 1024  # phase 12: visits a chain of each probe run (the probes' 4,096, cut for the plain walks' time)
SRC = "vk_gltf_renderer_tpu_torch/csrc/"
REF = "vk_gltf_renderer_tpu/"
TRAV_SRC = SRC + "traverse_bvh4.cu"
GATHER_SRC = SRC + "gather.cu"
LARGE_TRIS = 1_050_000  # scenes.write_large_glb target: 1,059,968 world triangles
LARGE_WORLD_TRIS = 1_059_968
SUBSET = 65_536  # rays the plain versions walk on the large scene
# cut for the run's time: the lanes of each replayed launch (phase 7b) and the probe rays of the refitted terrain
# (16c) that the plain walks take (65,536 before)
REPLAY_SUBSET = PLAIN_CHECK_RAYS = 16_384
SELECTIONS = (("v3", "v9"), ("v2", "v2"), ("v6", "v6"), ("lane", "lane_stream"),
              ("v5", "v5"), ("v7", "v7"), ("v3", "v8"))
# kernel value -> its wrapper's name in the JSON line
KERNEL_OF = {"v3": "traverse_bvh4", "v9": "traverse_bvh4", "v2": "traverse_bvh2",
             "v6": "traverse_bvh16", "lane": "traverse_lanes", "lane_stream": "traverse_lanes",
             "v5": "traverse_bvh4_multipop", "v7": "traverse_bvh4_sidecar",
             "v8": "traverse_bvh4_leafqueue"}
BVH4_VARIANTS = ("traverse_bvh4_multipop", "traverse_bvh4_sidecar", "traverse_bvh4_leafqueue")
# the kernels with live-lane compaction and a persistent grid (csrc/live_lanes.cuh)
COMPACTING = ("traverse_bvh4.cu", "traverse_lanes.cu", "traverse_bvh4_multipop.cu", "traverse_bvh2.cu",
              "traverse_bvh16.cu", "traverse_bvh4_sidecar.cu", "traverse_bvh4_split.cu",
              "traverse_bvh4_leafqueue.cu", "traverse_bvh2_split.cu")
# the sources whose registers and spills go into the JSON line: those and the megakernel (which
# takes only live_lanes.cuh's persistent grid)
RESOURCES = COMPACTING + ("megakernel.cu",)
# phase 7b's other replays: wrapper -> its kernel selection
REPLAYS = {"traverse_lanes": ("lane", "lane_stream"), "traverse_bvh4_multipop": ("v5", "v5"),
           "traverse_bvh2": ("v2", "v2"), "traverse_bvh16": ("v6", "v6"),
           "traverse_bvh4_leafqueue": ("v3", "v8")}
# table arguments before the 8 ray components of each replayed wrapper
TABLE_ARGS = {"traverse_bvh4": 3, "traverse_lanes": 1, "traverse_bvh4_multipop": 3, "traverse_bvh2": 3,
              "traverse_bvh16": 2, "traverse_bvh4_sidecar": 4, "traverse_bvh4_split": 3,
              "traverse_bvh4_leafqueue": 3}
# replayed wrappers timed beside traverse_bvh4 on the same lanes
BESIDE_BVH4 = ("traverse_bvh4_multipop", "traverse_bvh2", "traverse_bvh16", "traverse_bvh4_leafqueue")
# BVH4 kernels that walk traverse_bvh4's tree in another schedule, so that their closest-hit t
# equals traverse_bvh4's bit for bit: wrapper -> kernel value
SAME_TREE = {"traverse_bvh4_multipop": "v5", "traverse_bvh4_leafqueue": "v8"}
MEGA_DEPTHS = (1, 2, 5)
# the bound: H100 SXM peak HBM rate and dense FP32 rate, FLOPs per test
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BOX_FLOPS, TRI_FLOPS, SHADE_FLOPS = 24, 55, 20
RAY_BYTES = (8 + 5) * 4  # 8 f32 ray components in, 5 outputs of 4 bytes out
DEAD_RAY_BYTES = (1 + 5) * 4  # a dead lane: tmax in, 5 outputs out
PT = REF + "ops/pallas_traverse.py:"
# wrapper -> (source, file:line of the TPU kernel it replaces, also replaces)
SOURCES = {
    "traverse_bvh4": ("traverse_bvh4.cu", PT + "951", PT + "1450"),
    "gather_channels": ("gather.cu", REF + "ops/pallas_gather.py:44", None),
    "traverse_bvh2": ("traverse_bvh2.cu", PT + "1669", None),
    "traverse_bvh16": ("traverse_bvh16.cu", PT + "1640", None),
    "traverse_lanes": ("traverse_lanes.cu", REF + "ops/lane_traverse.py:407",
                       REF + "ops/lane_traverse.py:376"),
    "traverse_bvh4_multipop": ("traverse_bvh4_multipop.cu", PT + "913", None),
    "traverse_bvh4_sidecar": ("traverse_bvh4_sidecar.cu", PT + "951", None),
    "traverse_bvh4_leafqueue": ("traverse_bvh4_leafqueue.cu", PT + "1209", None),
    "render_mega": ("megakernel.cu", REF + "ops/megakernel.py:140", None),
    "traverse_bvh4_split": ("traverse_bvh4_split.cu", PT + "1895", None),
    "traverse_bvh2_split": ("traverse_bvh2_split.cu", PT + "1921", None),
    "probe_nodefetch": ("probe_nodefetch.cu", "tools/exp_nodefetch.py:90", None),
    "probe_visit": ("probe_visit.cu", "tools/exp_visit.py:190", None),
    "probe_stream_dma": ("probe_stream_dma.cu", "tools/exp_stream_dma.py:163", None),
    "probe_uarch": ("probe_uarch.cu", "tools/uarch_probe.py:19", None),
}
# split kernel -> (table family, intersect_rays_packet keywords, arity, bytes read of an
# internal node: packet4 96 box bytes of nodes4_f + 32 of nodes4_i, v1 48 of nodes_f + 32 of
# nodes_i; a v1 leaf node reads only its 32-byte nodes_i row, LEAF_NODE_BYTES)
SPLIT = {"traverse_bvh4_split": ("bvh4_split", {"wide": True}, 4, 128),
         "traverse_bvh2_split": ("bvh2_split", {"v2": False}, 2, 80)}
SPLIT_LEAF_BYTES = 64  # one tris row per triangle
LEAF_NODE_BYTES = 32
WAVEFRONT_SIZES = ((1920, 1080), (960, 540), (480, 270))
SUITE_SIZE = (1024, 1024)  # the suite stand-in's frame (BASELINE cfg row 3)
MATERIAL_TIMED = 2  # timed frames of each material scene
MATERIAL_FRAMES = ("game", "suite", "lit_game", "materials")  # phase 15's timed scenes
MATERIAL_PROFILED = ("suite",)  # profiled after their timed frames
MARCH_REPLAYS = ("game", "materials")  # phase 15's recorded frames
WAVEFRONT_FRAME_S = 10.0  # the longest wavefront frame the run takes


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU")
    smi = gpu_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return torch.device("cuda:0"), smi


def phase_build():
    from vk_gltf_renderer_tpu_torch import cuda_lib, native

    t0 = time.perf_counter()
    native.jpeg_lib()  # the host JPEG entropy coder (g++), which phase 20's codecs run on
    log(f"[build] native/jpeg_entropy.cpp built or found in {time.perf_counter() - t0:.1f} s")
    lib = cuda_lib.library()
    log(f"[build] {lib.path.name} built in {lib.build_seconds:.1f} s")
    for line in lib.compiler_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    return {src: kernel_resources(lib.compiler_log, src) for src in RESOURCES}


def kernel_resources(compiler_log, source):
    """Registers, spills and shared memory of every kernel instance of
    csrc/<source> (one of RESOURCES), from ptxas -v in the build log:
    instance -> dict. The walk's two instances are "walk closest" and
    "walk any" (v1's one walk, closest hit only, "walk closest"); the
    one-thread-per-lane kernel of bvh4_tuning.GENERIC (a
    tuning variant's walk before the redesign) is "walk (generic)", the
    megakernel "render_mega"."""
    out, name, section = {}, None, None
    for line in compiler_log.splitlines():
        if line.startswith("== "):
            section = line[3:].strip()
            continue
        if section != source:
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            w = re.search(r"walk_kernel(?:ILb([01])E)?", m.group(1))
            name = f"walk {('closest', 'any')[int(w.group(1) or 0)]}" if w else (
                "compact_lanes" if "compact_lanes" in m.group(1) else
                "render_mega" if "render_mega_kernel" in m.group(1) else
                "walk (generic)" if "traverse_bvh_kernel" in m.group(1) else m.group(1))
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(s.group(1)) if s else 0
    for inst, res in out.items():
        log(f"[build] {source} {inst}: {res}")
    return out


def helmet_renderer(tmp, device):
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.scenes import make_helmet_standin, write_synthetic_hdr

    scene = make_helmet_standin(tmp)
    hdr = write_synthetic_hdr(os.path.join(tmp, "sky.hdr"), 256, 512, seed=0)
    r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
    return r, scene, hdr


def probe_rays(r, device):
    """Camera rays of the 1080p frame at stride 2, plus as many incoherent
    rays from random points inside the scene bounds."""
    from vk_gltf_renderer_tpu_torch.ops.camera import generate_rays

    fr = r._frame_inputs()
    xs, ys = torch.meshgrid(torch.arange(0, FRAME_W, 2, device=device),
                            torch.arange(0, FRAME_H, 2, device=device), indexing="xy")
    pos = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float()
    ro_c, rd_c = generate_rays(pos, torch.full_like(pos, 0.5),
                               torch.tensor([FRAME_W, FRAME_H], dtype=torch.float32, device=device),
                               fr["proj_inv"], fr["view_inv"])
    n = pos.shape[0]
    g = torch.Generator(device="cpu").manual_seed(1234)
    lo, hi = r.dev_bvh.scene_lo, r.dev_bvh.scene_hi
    ro_i = lo + torch.rand((n, 3), generator=g).to(device) * (hi - lo)
    rd_i = torch.randn((n, 3), generator=g).to(device)
    rd_i = rd_i / rd_i.norm(dim=1, keepdim=True)
    return torch.cat([ro_c, ro_i]), torch.cat([rd_c, rd_i])


def _traversal_modules():
    from vk_gltf_renderer_tpu_torch.ops import (lane_traverse, traverse_bvh2, traverse_bvh2_split,
                                                traverse_bvh4, traverse_bvh4_leafqueue,
                                                traverse_bvh4_multipop, traverse_bvh4_sidecar,
                                                traverse_bvh4_split, traverse_bvh16)

    return {"traverse_bvh2": traverse_bvh2, "traverse_bvh4": traverse_bvh4,
            "traverse_bvh16": traverse_bvh16, "traverse_lanes": lane_traverse,
            "traverse_bvh4_multipop": traverse_bvh4_multipop,
            "traverse_bvh4_sidecar": traverse_bvh4_sidecar,
            "traverse_bvh4_leafqueue": traverse_bvh4_leafqueue,
            "traverse_bvh4_split": traverse_bvh4_split,
            "traverse_bvh2_split": traverse_bvh2_split}


def _traversal_runs(bvh):
    """wrapper name -> (kernel call, plain call, arity, bytes of a node row)
    over the 8 ray components, for every traversal kernel whose tables bvh
    (convert.DeviceBvh) holds. The plain calls take stats=."""
    from vk_gltf_renderer_tpu_torch.ops import traverse as tt

    mods = _traversal_modules()
    runs = {}
    tables = {  # name -> (kernel function, plain function, table args, arity, node row bytes)
        "traverse_bvh2": (mods["traverse_bvh2"].traverse_bvh2, tt.traverse_bvh2_plain,
                          (bvh.nodes_fi, bvh.tris128, bvh.root_code), 2, 64),
        "traverse_bvh16": (mods["traverse_bvh16"].traverse_bvh16, tt.traverse_bvh16_plain,
                           (bvh.nodes16_fi, bvh.tris128), 16, 512),
        "traverse_lanes": (mods["traverse_lanes"].traverse_lanes, tt.traverse_lanes_plain,
                           (bvh.lane_entries,), 1, 64),
        "traverse_bvh4": (mods["traverse_bvh4"].traverse_bvh4, tt.traverse_bvh4_plain,
                          (bvh.nodes4_fi, bvh.tris128, bvh.root4_code), 4, 128),
        "traverse_bvh4_multipop": (mods["traverse_bvh4_multipop"].traverse_bvh4_multipop,
                                   tt.traverse_bvh4_multipop_plain,
                                   (bvh.nodes4_fi, bvh.tris128, bvh.root4_code), 4, 128),
        # v7 reads the 96 box bytes of a nodes4_fi row and a 32-byte sidecar row
        "traverse_bvh4_sidecar": (mods["traverse_bvh4_sidecar"].traverse_bvh4_sidecar,
                                  tt.traverse_bvh4_sidecar_plain,
                                  (bvh.nodes4_fi, bvh.nodes4_sc, bvh.tris128, bvh.root4_code), 4, 128),
        "traverse_bvh4_leafqueue": (mods["traverse_bvh4_leafqueue"].traverse_bvh4_leafqueue,
                                    tt.traverse_bvh4_leafqueue_plain,
                                    (bvh.nodes4_fi, bvh.tris128, bvh.root4_code), 4, 128),
    }
    for name, (kern, plain, args, arity, row_bytes) in tables.items():
        if any(a is None for a in args):
            continue
        # the BVH16 kernel takes no root code; its plain version does (0)
        plain_args = args + (0,) if name == "traverse_bvh16" else args
        runs[name] = (lambda *a, anyhit, k=kern, t=args: k(*t, *a, anyhit=anyhit),
                      lambda *a, anyhit, stats=None, f=plain, t=plain_args: f(*t, *a, anyhit=anyhit,
                                                                              stats=stats),
                      arity, row_bytes)
    return runs


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the FLOPs over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _visits(stats, arity, row_bytes, leaf_bytes=512):
    """(table bytes touched, FLOPs, description) of a plain walk's counts;
    leaf_bytes: bytes of one leaf row (a tris128 row, or a tris row)."""
    if "entries" in stats:  # the lane walk: a box test or a triangle test per entry
        rows = int(stats["entry_rows"].sum())
        return (rows * 64, stats["box_entries"] * BOX_FLOPS + stats["tri_entries"] * TRI_FLOPS,
                f"{stats['entries']} entry visits ({stats['box_entries']} box, {stats['tri_entries']} "
                f"triangle; {stats['plus_one']} to the next entry; load rounds by window "
                f"{stats['rounds']}), {rows} distinct entries")
    nodes, leaves = int(stats["node_rows"].sum()), int(stats["leaf_rows"].sum())
    # the v1 walk's leaf nodes: their nodes_i rows (the other walks code leaves in the parent)
    metas = int(stats["leaf_node_rows"].sum()) if "leaf_node_rows" in stats else 0
    return (nodes * row_bytes + metas * LEAF_NODE_BYTES + leaves * leaf_bytes,
            stats["internal"] * arity * BOX_FLOPS + stats["tris"] * TRI_FLOPS,
            f"{stats['internal']} internal + {stats['leaf']} leaf visits, {stats['tris']} "
            f"triangle tests, {nodes} node rows + {metas} leaf node rows + {leaves} leaf rows "
            "touched")


def traversal_bound(stats, arity, row_bytes, n_rays, n_walked, leaf_bytes=512, n_dead=0):
    """Bound of one launch on n_rays from the plain version's counts on
    n_walked of them: distinct rows as counted, visits scaled. n_dead of
    the rays are dead lanes (!(tmax >= 0) at an internal root): their
    result is (tmax, -1, -1, 0, 0) whatever their other components, so
    they move only DEAD_RAY_BYTES."""
    table_bytes, flops, desc = _visits(stats, arity, row_bytes, leaf_bytes)
    ray_bytes = (n_rays - n_dead) * RAY_BYTES + n_dead * DEAD_RAY_BYTES
    ms, by = bound(table_bytes + ray_bytes, flops * n_rays / n_walked)
    return ms, by, f"{desc} on {n_walked} rays"


OUTPUTS = ("t", "rnode", "tri", "u", "v")


def same_bits(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _require_bits(what, out, ref):
    """All five outputs equal bit for bit on every lane."""
    differ = [name for name, o, r in zip(OUTPUTS, out, ref) if not same_bits(o, r)]
    require(not differ, f"{what}: {differ} differ from v7's")


def _time_interleaved(calls, reps):
    """Device ms of each call (device_ms over reps), timed in two rounds,
    forward and backward, and averaged, so that no version has the card
    to itself at one end of the run."""
    ms = {k: [] for k in calls}
    for order in (list(calls), list(calls)[::-1]):
        for k in order:
            ms[k].append(device_ms(calls[k], reps))
    return {k: sum(v) / len(v) for k, v in ms.items()}


def _bvh4_vs_v7(bvh, rays, anyhit):
    """traverse_bvh4 and v7 on the same 8 ray components: equal bit for bit
    on every lane, then timed in interleaved rounds. Returns
    {"traverse_bvh4": ms, "v7": ms}."""
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_sidecar as tbsc

    def v7():
        return tbsc.traverse_bvh4_sidecar(bvh.nodes4_fi, bvh.nodes4_sc, bvh.tris128, bvh.root4_code,
                                          *rays, anyhit=anyhit)

    def new():
        return tb4.traverse_bvh4(bvh.nodes4_fi, bvh.tris128, bvh.root4_code, *rays, anyhit=anyhit)

    _require_bits("traverse_bvh4", new(), v7())
    return _time_interleaved({"traverse_bvh4": new, "v7": v7}, 10)


def _bvh4_probe_vs_v7(tag, bvh, comps, tmin, far, shadow_tmax, resources):
    """traverse_bvh4 beside v7 on the probe rays, closest and any hit
    (bit-equal on every ray); resources: kernel_resources of the build,
    whose walk instances are printed."""
    for hit in ("closest", "any"):
        log(f"[{tag}] traverse_bvh4 walk, {hit} hit: {resources.get(f'walk {hit}', 'not in this build log')}; "
            f"compact_lanes: {resources.get('compact_lanes', 'not in this build log')}")
    res = {}
    for anyhit, tmax in ((False, far), (True, shadow_tmax)):
        times = _bvh4_vs_v7(bvh, (*comps, tmin, tmax), anyhit)
        hit = "any" if anyhit else "closest"
        log(f"[{tag}] traverse_bvh4 {hit} hit on {comps[0].shape[0]} rays, equal to v7 bit for bit: "
            f"{times['traverse_bvh4']:.4f} ms, v7 {times['v7']:.4f} ms "
            f"(v7 / traverse_bvh4 {times['v7'] / times['traverse_bvh4']:.2f}x)")
        res[hit] = times
    return res


def _same_tree_vs_bvh4(name, bvh, rays, anyhit):
    """BVH4 kernel `name` of SAME_TREE (v5, v8) beside traverse_bvh4 on the
    same 8 ray components: closest hit t equal bit for bit on every lane
    (ids, u and v may then differ only at equal-t ties, which are counted),
    any hit occlusion equal; both timed in interleaved rounds. Returns
    {name: ms, "traverse_bvh4": ms, "ties": lanes}."""
    mods = _traversal_modules()
    tables = (bvh.nodes4_fi, bvh.tris128, bvh.root4_code)
    tag = SAME_TREE[name]

    def own():
        return getattr(mods[name], name)(*tables, *rays, anyhit=anyhit)

    def bvh4():
        return mods["traverse_bvh4"].traverse_bvh4(*tables, *rays, anyhit=anyhit)

    out, ref = own(), bvh4()
    require(torch.equal(out[2] >= 0, ref[2] >= 0), f"{tag}: hit or occlusion differs from traverse_bvh4's")
    ties = 0
    if not anyhit:
        require(same_bits(out[0], ref[0]), f"{tag}: t differs from traverse_bvh4's on "
                f"{int((out[0].view(torch.int32) != ref[0].view(torch.int32)).sum())} lanes")
        ties = int(((out[1] != ref[1]) | (out[2] != ref[2]) | (out[3].view(torch.int32) != ref[3].view(torch.int32))
                    | (out[4].view(torch.int32) != ref[4].view(torch.int32))).sum())
    times = _time_interleaved({name: own, "traverse_bvh4": bvh4}, 10)
    return dict(times, ties=ties)


def _same_tree_probe_vs_bvh4(tag, name, bvh, comps, tmin, far, shadow_tmax):
    """_same_tree_vs_bvh4 on the probe rays, closest and any hit."""
    res = {}
    kv = SAME_TREE[name]
    for anyhit, tmax in ((False, far), (True, shadow_tmax)):
        r = _same_tree_vs_bvh4(name, bvh, (*comps, tmin, tmax), anyhit)
        hit = "any" if anyhit else "closest"
        log(f"[{tag}] {kv} {hit} hit on {comps[0].shape[0]} rays: "
            + ("t equal to traverse_bvh4's bit for bit on every lane, ids or u/v differ on "
               f"{r['ties']} (equal-t ties)" if not anyhit else "occlusion equal to traverse_bvh4's")
            + f"; {kv} {r[name]:.4f} ms, traverse_bvh4 {r['traverse_bvh4']:.4f} ms "
            f"({kv} / traverse_bvh4 {r[name] / r['traverse_bvh4']:.2f}x)")
        res[hit] = r
    return res


def _beside_bvh4(bvh, name, kern, rays, anyhit):
    """Kernel `name` (BVH2 or BVH16, another tree than traverse_bvh4's)
    beside traverse_bvh4 on the same 8 ray components, timed in
    interleaved rounds. Returns {name: ms, "traverse_bvh4": ms,
    "t_differs": lanes}: the lanes whose t bits differ, which only an
    equal-t tie or a leaf box that one tree's t_best culls at its face can
    make."""
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4

    def bvh4():
        return tb4.traverse_bvh4(bvh.nodes4_fi, bvh.tris128, bvh.root4_code, *rays, anyhit=anyhit)

    def own():
        return kern(*rays, anyhit=anyhit)

    out, ref = own(), bvh4()
    differs = int((out[0].view(torch.int32) != ref[0].view(torch.int32)).sum())
    return dict(_time_interleaved({name: own, "traverse_bvh4": bvh4}, 10), t_differs=differs)


def _v1_beside_v2(device, bvh, rays, anyhit, k):
    """v1 (traverse_bvh2_split, closest hit only) on one replayed launch of
    traverse_bvh2, the same binary tree walked in the same near-first
    order, beside traverse_bvh2 on the same 8 ray components: for a
    closest-hit launch t equal bit for bit on every lane and the (rnode,
    tri) pair after v1's row resolution equal except on equal-t ties (the
    lanes that differ counted); for an any-hit launch, which v1 traces
    closest hit, the occlusion equal. Both timed in interleaved rounds; v1
    held against its plain version on a fixed subset of REPLAY_SUBSET lanes, with
    its bound. Returns dict(ms, traverse_bvh2, id_ties, uv_differ,
    bound_ms, max_abs_err)."""
    from vk_gltf_renderer_tpu_torch.ops import traverse as tt
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh2 as tb2
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh2_split as tb2s

    name = "traverse_bvh2_split"
    tables = (bvh.nodes_f, bvh.nodes_i, bvh.tris)

    def v1(*a):
        return tb2s.traverse_bvh2_split(*tables, *(a or rays), root_leaf=bvh.bvh2_split_root_leaf)

    def v2():
        return tb2.traverse_bvh2(bvh.nodes_fi, bvh.tris128, bvh.root_code, *rays, anyhit=anyhit)

    (t1, _, row, u1, w1), (t2, rn2, tri2, u2, w2) = v1(), v2()
    require(torch.equal(row >= 0, tri2 >= 0), f"v1: hit or occlusion differs from traverse_bvh2's on "
            f"{int((row >= 0).ne(tri2 >= 0).sum())} lanes")
    id_ties = uv_differ = 0
    if not anyhit:
        require(same_bits(t1, t2), f"v1: t differs from traverse_bvh2's on "
                f"{int((t1.view(torch.int32) != t2.view(torch.int32)).sum())} lanes")
        safe = row.clamp(min=0).long()
        rn1 = torch.where(row >= 0, bvh.wtri_rnode[safe], -1)
        tri1 = torch.where(row >= 0, bvh.wtri_tri[safe], -1)
        id_ties = int(((rn1 != rn2) | (tri1 != tri2)).sum())
        uv_differ = int(((u1.view(torch.int32) != u2.view(torch.int32))
                         | (w1.view(torch.int32) != w2.view(torch.int32))).sum())
    times = _time_interleaved({name: v1, "traverse_bvh2": v2}, 10)
    n = rays[0].shape[0]
    live = int((rays[7] >= 0).sum())
    sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(80 + k))[:REPLAY_SUBSET]
    sargs = tuple(a[sub.to(device)].contiguous() for a in rays)
    stats = {}
    err = _check_against_plain(name, v1(*sargs), tt.traverse_bvh2_split_plain(*tables, *sargs, stats=stats),
                               REPLAY_SUBSET, False)
    _, _, arity, row_bytes = SPLIT[name]
    n_dead = 0 if bvh.bvh2_split_root_leaf else n - live
    b_ms, b_by, visits = traversal_bound(stats, arity, row_bytes, n, REPLAY_SUBSET, SPLIT_LEAF_BYTES, n_dead=n_dead)
    return dict(ms=times[name], traverse_bvh2=times["traverse_bvh2"], id_ties=id_ties, uv_differ=uv_differ,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err, visits=visits)


def record_launches(r, wrapper):
    """One frame of renderer r through on_render, with
    ops.intersect.<wrapper> (a key of TABLE_ARGS) wrapped to record clones
    of each launch's 8 ray components; returns ([(components, anyhit)], the
    frame's aux). anyhit is False for a wrapper without the flag (packet4)."""
    from vk_gltf_renderer_tpu_torch.ops import intersect

    recorded = []
    traced = getattr(intersect, wrapper)
    skip = TABLE_ARGS[wrapper]

    def record(*args, **kw):
        recorded.append(([c.clone() for c in args[skip:]], kw.get("anyhit", False)))
        return traced(*args, **kw)

    setattr(intersect, wrapper, record)
    try:
        aux = r.on_render()
    finally:
        setattr(intersect, wrapper, traced)
    torch.cuda.synchronize()
    return recorded, aux


def phase_replay(device, scenes, smi):
    """The main path's traverse_bvh4 launches replayed: one (v3, v9) frame
    per scene through on_render with ops.intersect.traverse_bvh4 wrapped
    to record clones of each launch's 8 ray components; then every launch
    through traverse_bvh4 and v7 (bit-equal on every lane, timed in
    interleaved rounds), against the plain version on a fixed subset of
    REPLAY_SUBSET lanes (dead lanes included), with its bound."""
    from vk_gltf_renderer_tpu_torch.convert import add_kernel_tables_to_device
    from vk_gltf_renderer_tpu_torch.ops import traverse as tt
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.ops.bvh_flatten import add_kernel_tables

    results = {}
    for label, r in scenes:
        add_kernel_tables(r.bvh, {"bvh4_sidecar"})
        add_kernel_tables_to_device(r.dev_bvh, r.bvh, device, {"bvh4_sidecar"})
        bvh = r.dev_bvh
        require(bvh.root4_code >= 0, f"{label}: the BVH4 root is a leaf")
        recorded, aux = record_launches(r, "traverse_bvh4")
        # a closest and a shadow launch per bounce while any path is alive
        require(0 < len(recorded) <= 2 * DEPTH, f"{label}: {len(recorded)} traverse_bvh4 launches in a frame")
        launches, frame = [], {}
        for k, (rays, anyhit) in enumerate(recorded):
            n = rays[0].shape[0]
            live = int((rays[7] >= 0).sum())
            times = _bvh4_vs_v7(bvh, rays, anyhit)
            sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(50 + k))[:REPLAY_SUBSET]
            sargs = tuple(a[sub.to(device)].contiguous() for a in rays)
            stats = {}
            tables = (bvh.nodes4_fi, bvh.tris128, bvh.root4_code)
            err = _check_against_plain("traverse_bvh4", tb4.traverse_bvh4(*tables, *sargs, anyhit=anyhit),
                                       tt.traverse_bvh4_plain(*tables, *sargs, anyhit=anyhit, stats=stats),
                                       REPLAY_SUBSET, anyhit)
            b_ms, b_by, visits = traversal_bound(stats, 4, 128, n, REPLAY_SUBSET, n_dead=n - live)
            hit = "any" if anyhit else "closest"
            log(f"[replay] {label} launch {k} ({hit} hit): {n} lanes, {live} live ({100 * live / n:.2f}%): "
                f"traverse_bvh4 {times['traverse_bvh4']:.4f} ms, v7 {times['v7']:.4f} ms; bound {b_ms:.4f} ms "
                f"({b_by}); equal to v7 bit for bit on every lane; plain on {REPLAY_SUBSET} lanes "
                f"({int((sargs[7] >= 0).sum())} live), max err {err:.3g}; visits {visits}")
            launches.append(dict(hit=hit, lanes=n, live=live, bound_ms=b_ms, max_abs_err=err, **times))
            for key, v in times.items():
                frame[key] = frame.get(key, 0.0) + v
        frame_bound = sum(x["bound_ms"] for x in launches)
        live_sum = sum(x["live"] for x in launches)
        log(f"[replay] {label} frame ({len(launches)} launches, {live_sum} live lanes; the frame counted "
            f"{float(aux['rays']):.0f} rays): traverse_bvh4 {frame['traverse_bvh4']:.4f} ms, v7 "
            f"{frame['v7']:.4f} ms (v7 / traverse_bvh4 {frame['v7'] / frame['traverse_bvh4']:.2f}x), bound "
            f"{frame_bound:.4f} ms, on {smi}")
        later = {key: sum(x[key] for x in launches[1:]) for key in ("traverse_bvh4", "v7")}
        log(f"[replay] {label} the {len(launches) - 1} launches after bounce 0's closest hit: traverse_bvh4 "
            f"{later['traverse_bvh4']:.4f} ms, v7 {later['v7']:.4f} ms")
        results[label] = dict(frame=dict(frame, bound_ms=frame_bound, live=live_sum,
                                         rays=float(aux["rays"])),
                              launches=launches)
        del recorded
    return results


def phase_replay_selections(device, scenes, smi):
    """Phase 7b for the other redesigned kernels: per REPLAYS selection
    ((lane, lane_stream), (v5, v5), (v2, v2), (v6, v6), (v3, v8)) one 1080p
    frame per scene through on_render with the selection's wrapper recorded
    (10 launches: closest and shadow per bounce; v8 the 9 after bounce 0's
    closest hit, which goes to v3), then every launch timed, held
    against the plain version on a fixed subset of REPLAY_SUBSET lanes (dead lanes
    included), with its bound; the launches of BESIDE_BVH4 also beside
    traverse_bvh4 on the same lanes (v5, v8: _same_tree_vs_bvh4, closest-hit
    t bit for bit on every lane; v2, v6: _beside_bvh4), and the (v2, v2)
    launches also through v1 beside traverse_bvh2 (_v1_beside_v2). Nothing
    may be dropped.
    Returns wrapper -> scene -> dict(frame, launches), "traverse_bvh2_split"
    among the wrappers."""
    from vk_gltf_renderer_tpu_torch.convert import add_kernel_tables_to_device

    mods = _traversal_modules()
    results = {"traverse_bvh2_split": {}}
    mods["traverse_bvh2_split"].OVERFLOW.reset()
    for name, selection in REPLAYS.items():
        os.environ["VKGR_PRIMARY_KERNEL"], os.environ["VKGR_PACKET_KERNEL"] = selection
        mod = mods[name]
        mod.OVERFLOW.reset()
        results[name] = {}
        for label, r in scenes:
            t_scene = time.perf_counter()
            recorded, aux = record_launches(r, name)
            require(0 < len(recorded) <= 2 * DEPTH, f"{label} {selection}: {len(recorded)} {name} launches")
            kern, plain, arity, row_bytes = _traversal_runs(r.dev_bvh)[name]
            if name == "traverse_bvh2":  # v1 on the same lanes: its split tables
                add_kernel_tables_to_device(r.dev_bvh, r.bvh, device, {"bvh2_split"})
            launches, v1_launches = [], []
            for k, (rays, anyhit) in enumerate(recorded):
                n = rays[0].shape[0]
                live = int((rays[7] >= 0).sum())
                if name in SAME_TREE:
                    times = _same_tree_vs_bvh4(name, r.dev_bvh, rays, anyhit)
                    ms = times[name]
                elif name in BESIDE_BVH4:
                    times = _beside_bvh4(r.dev_bvh, name, kern, rays, anyhit)
                    ms = times[name]
                else:
                    ms = device_ms(lambda rays=rays, anyhit=anyhit: kern(*rays, anyhit=anyhit), 10)
                    times = {}
                sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(60 + k))[:REPLAY_SUBSET]
                sargs = tuple(a[sub.to(device)].contiguous() for a in rays)
                stats = {}
                err = _check_against_plain(name, kern(*sargs, anyhit=anyhit),
                                           plain(*sargs, anyhit=anyhit, stats=stats), REPLAY_SUBSET, anyhit)
                b_ms, b_by, visits = traversal_bound(stats, arity, row_bytes, n, REPLAY_SUBSET, n_dead=n - live)
                hit = "any" if anyhit else "closest"
                beside = (f", traverse_bvh4 {times['traverse_bvh4']:.4f} ms on the same lanes "
                          + (f"(t equal bit for bit, {times['ties']} equal-t ties)" if "ties" in times else
                             f"(t differs on {times['t_differs']} lanes)") if times else "")
                log(f"[replay] {selection} {label} launch {k} ({hit} hit): {n} lanes, {live} live "
                    f"({100 * live / n:.2f}%): {name} {ms:.4f} ms{beside}; bound {b_ms:.4f} ms ({b_by}); plain on "
                    f"{REPLAY_SUBSET} lanes ({int((sargs[7] >= 0).sum())} live), max err {err:.3g}; visits {visits}")
                launches.append(dict(hit=hit, lanes=n, live=live, ms=ms, bound_ms=b_ms, max_abs_err=err,
                                     **{k2: v for k2, v in times.items() if k2 != name}))
                if name == "traverse_bvh2":
                    v1 = _v1_beside_v2(device, r.dev_bvh, rays, anyhit, k)
                    log(f"[replay] {selection} {label} launch {k} ({hit} hit) through v1: traverse_bvh2_split "
                        f"{v1['ms']:.4f} ms, traverse_bvh2 {v1['traverse_bvh2']:.4f} ms on the same lanes ("
                        + (f"t equal bit for bit on every lane, (rnode, tri) differs on {v1['id_ties']} "
                           f"(equal-t ties), u/v on {v1['uv_differ']}" if not anyhit else
                           "occlusion equal; v1 traces the segments closest hit")
                        + f"); bound {v1['bound_ms']:.4f} ms ({v1['bound_by']}); plain on {REPLAY_SUBSET} lanes, "
                        f"max err {v1['max_abs_err']:.3g}; visits {v1.pop('visits')}")
                    v1_launches.append(dict(hit=hit, lanes=n, live=live, **v1))
            frame = dict(ms=sum(x["ms"] for x in launches), bound_ms=sum(x["bound_ms"] for x in launches),
                         live=sum(x["live"] for x in launches), rays=float(aux["rays"]))
            if name in BESIDE_BVH4:
                frame["traverse_bvh4_ms"] = sum(x["traverse_bvh4"] for x in launches)
            if name in SAME_TREE:
                frame["ties"] = sum(x["ties"] for x in launches)
            log(f"[replay] {selection} {label} frame ({len(launches)} launches, {frame['live']} live lanes; "
                f"the frame counted {frame['rays']:.0f} rays): {name} {frame['ms']:.4f} ms, bound "
                f"{frame['bound_ms']:.4f} ms" + (f", traverse_bvh4 on the same lanes {frame['traverse_bvh4_ms']:.4f} ms"
                                                 if "traverse_bvh4_ms" in frame else "") + f", on {smi} "
                f"(the replay took {time.perf_counter() - t_scene:.1f} s)")
            results[name][label] = dict(frame=frame, launches=launches)
            if v1_launches:
                v1_frame = {key: sum(x[key] for x in v1_launches)
                            for key in ("ms", "traverse_bvh2", "bound_ms", "live", "id_ties", "uv_differ")}
                v1_frame.update(rays=frame["rays"], traverse_bvh2_ms=v1_frame.pop("traverse_bvh2"))
                log(f"[replay] {selection} {label} frame through v1 ({len(v1_launches)} launches): "
                    f"traverse_bvh2_split {v1_frame['ms']:.4f} ms, traverse_bvh2 on the same lanes "
                    f"{v1_frame['traverse_bvh2_ms']:.4f} ms, bound {v1_frame['bound_ms']:.4f} ms; "
                    f"(rnode, tri) equal-t ties {v1_frame['id_ties']}, on {smi}")
                results["traverse_bvh2_split"][label] = dict(frame=v1_frame, launches=v1_launches)
        dropped = mod.OVERFLOW.total()
        require(dropped == 0, f"{name}: the replay dropped {dropped} (stack overflow / bad link)")
    dropped = mods["traverse_bvh2_split"].OVERFLOW.total()
    require(dropped == 0, f"traverse_bvh2_split: the replay dropped {dropped}")
    for key in ("VKGR_PRIMARY_KERNEL", "VKGR_PACKET_KERNEL"):
        os.environ.pop(key, None)
    return results


def _check_against_plain(name, k, p, n, anyhit):
    """Kernel outputs k against plain outputs p (5 tensors + dropped count)
    on the same n rays; returns max |t,u,v| difference on hits."""
    kt, krn, ktri, ku, kv = k
    pt, prn, ptri, pu, pv, dropped = p
    require(dropped == 0, f"{name}: plain version dropped {dropped}")
    hit = ptri >= 0
    require(torch.equal(ktri >= 0, hit), f"{name} anyhit={anyhit}: kernel and plain disagree on "
            f"hit/miss for {int((ktri >= 0).ne(hit).sum())} rays")
    if anyhit:
        log(f"[kernels] {name} any hit: {int(hit.sum())} occluded, occlusion equal on all {n} rays")
        return 0.0
    same = (ktri == ptri) & (krn == prn)
    tie = (kt - pt).abs() <= 1e-6 * pt.abs()
    require(bool((same | tie | ~hit).all()),
            f"{name}: ids differ beyond equal-t ties on {int((~(same | tie) & hit).sum())} rays")
    both = same & hit

    def most(x):  # max |x|, 0 over no element (a sparse replayed launch's subset may hit nothing)
        return float(x.abs().max()) if x.numel() else 0.0

    err = max(most((kt - pt)[hit]), most((ku - pu)[both]), most((kv - pv)[both]))
    require(bool(((kt - pt)[hit].abs() <= 1e-5 * (1 + pt[hit].abs())).all()), f"{name}: t beyond 1e-5")
    require(most((ku - pu)[both]) <= 1e-5 and most((kv - pv)[both]) <= 1e-5, f"{name}: u/v beyond 1e-5")
    log(f"[kernels] {name} closest hit: {int(hit.sum())} hits of {n}, ids equal on {int(same.sum())}, "
        f"max |t,u,v err| {err:.3g}")
    return err


def _run_kernels(tag, names, runs, comps, tmin, far, shadow_tmax, sub):
    """Each named kernel closest and any hit on all rays (CUDA events) and
    against its plain version on the rays `sub` (None: all); returns
    name -> numbers, bound included (from the closest-hit visit counts)."""
    mods = _traversal_modules()
    n = comps[0].shape[0]
    n_plain = n if sub is None else sub.shape[0]
    results = {}
    for name in names:
        kern, plain, arity, row_bytes = runs[name]
        mods[name].OVERFLOW.reset()
        res = {"rays": n, "plain_rays": n_plain}
        for anyhit, tmax in ((False, far), (True, shadow_tmax)):
            args = (*comps, tmin, tmax)
            ms = device_ms(lambda: kern(*args, anyhit=anyhit), 10)
            sargs = args if sub is None else tuple(a[sub].contiguous() for a in args)
            k = kern(*sargs, anyhit=anyhit)
            stats = None if anyhit else {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = plain(*sargs, anyhit=anyhit, stats=stats)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = _check_against_plain(name, k, p, n_plain, anyhit)
            hit_tag = "anyhit_" if anyhit else ""
            res.update({f"{hit_tag}ms": ms, f"{hit_tag}plain_ms": plain_ms})
            if not anyhit:
                res["max_abs_err"] = err
                res["bound_ms"], res["bound_by"], visits = traversal_bound(stats, arity, row_bytes,
                                                                           n, n_plain)
                log(f"[{tag}] {name} visits (closest hit): {visits}; bound {res['bound_ms']:.4f} ms "
                    f"({res['bound_by']}) for {n} rays")
            log(f"[{tag}] {name} {'any' if anyhit else 'closest'} hit: kernel {ms:.3f} ms for {n} rays "
                f"({n / ms / 1e3:.1f} Mrays/s); plain torch {plain_ms:.1f} ms for {n_plain} rays")
        dropped = mods[name].OVERFLOW.total()
        require(dropped == 0, f"{name}: the kernel dropped {dropped} (stack overflow / bad link)")
        res["overflow"] = dropped
        results[name] = res
    return results


def _all_tables(r, device):
    """Build (host) and upload every optional kernel table of renderer r;
    returns the seconds each host table took."""
    from vk_gltf_renderer_tpu_torch.convert import add_kernel_tables_to_device
    from vk_gltf_renderer_tpu_torch.ops.bvh_flatten import add_kernel_tables

    secs = {}
    for family in ("bvh2", "bvh16", "lane", "bvh4_sidecar", "bvh4_multipop", "bvh4_split",
                   "bvh2_split", "wavefront"):
        t0 = time.perf_counter()
        add_kernel_tables(r.bvh, {family})
        add_kernel_tables_to_device(r.dev_bvh, r.bvh, device, {family})
        torch.cuda.synchronize()
        secs[family] = time.perf_counter() - t0
    return secs


def phase_kernels(device, resources):
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather

    with tempfile.TemporaryDirectory() as tmp:
        r, scene, _ = helmet_renderer(tmp, device)
        r.create_scene(scene)
        _all_tables(r, device)
        bvh = r.dev_bvh
        ro, rd = probe_rays(r, device)
    n = ro.shape[0]
    comps = [ro[:, i].contiguous() for i in range(3)] + [rd[:, i].contiguous() for i in range(3)]
    tmin = torch.zeros(n, device=device)
    g = torch.Generator(device="cpu").manual_seed(99)
    diag = float((bvh.scene_hi - bvh.scene_lo).norm())
    shadow_tmax = (torch.rand(n, generator=g) * diag).to(device)
    log(f"[kernels] helmet stand-in: {bvh.num_world_tris} world tris, nodes4_fi "
        f"{tuple(bvh.nodes4_fi.shape)}, tris128 {tuple(bvh.tris128.shape)}; {n} rays; stack need "
        f"{bvh.stack_need}")

    # BVH4 and its variants, against their plain versions on all of these rays
    far = torch.full((n,), 1e32, device=device)
    results = _run_kernels("kernels", ("traverse_bvh4",) + BVH4_VARIANTS, _traversal_runs(bvh), comps,
                           tmin, far, shadow_tmax, None)
    results["traverse_bvh4"]["against_v7"] = _bvh4_probe_vs_v7("kernels", bvh, comps, tmin, far, shadow_tmax,
                                                            resources["traverse_bvh4.cu"])
    for name in SAME_TREE:
        results[name]["against_traverse_bvh4"] = _same_tree_probe_vs_bvh4("kernels", name, bvh, comps, tmin, far,
                                                                          shadow_tmax)

    gen = torch.Generator(device="cpu").manual_seed(7)
    tab = torch.randn((4, 64 * 128), generator=gen).to(device)
    idx = torch.randint(0, tab.shape[1], (2_000_000,), generator=gen, dtype=torch.int32).to(device)
    out = tgather.gather_channels(tab, idx)
    ref = tab[:, idx.long()]
    require(torch.equal(out, ref), "gather kernel differs from tab[:, idx]")
    require(torch.equal(torch.index_select(tab, 1, idx), ref), "index_select differs from tab[:, idx]")
    g_ms = device_ms(lambda: tgather.gather_channels(tab, idx), 50)
    g_plain = device_ms(lambda: tgather.gather_channels_plain(tab, idx), 50)
    g_lib = device_ms(lambda: torch.index_select(tab, 1, idx), 50)
    g_bound, g_by = bound(tab.numel() * 4 + idx.numel() * 4 + out.numel() * 4, 0)
    log(f"[kernels] gather_channels [4,8192] x 2M: kernel {g_ms:.4f} ms, plain torch {g_plain:.4f} ms, "
        f"torch.index_select {g_lib:.4f} ms, bound {g_bound:.4f} ms ({g_by}), exact")
    results["gather_channels"] = dict(max_abs_err=float((out - ref).abs().max()), ms=g_ms, plain_ms=g_plain,
                                      library_ms=g_lib, bound_ms=g_bound, bound_by=g_by)
    return results, r, (ro, rd)


def phase_main_path(device, tmp, smi):
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4

    r, scene, hdr = helmet_renderer(tmp, device)
    tb4.COUNTER.launches = 0
    tgather.COUNTER.launches = 0
    tb4.OVERFLOW.reset()
    r.create_scene(scene)
    r.create_hdr(hdr)
    cfg = r._config()
    log(f"[main] {FRAME_W}x{FRAME_H} spp {SPP} depth {DEPTH}, features {sorted(cfg.features)}, env {cfg.env_kind}")
    times, rays, first = _render_frames(r, WARMUP, TIMED)
    launches = {"traverse_bvh4": tb4.COUNTER.launches, "gather_channels": tgather.COUNTER.launches}
    overflow = tb4.OVERFLOW.total()
    img = r.image_linear()
    r.save_image(os.path.join(tmp, "helmet_1080p.png"))

    require(r.accum.is_cuda, "accumulation buffer is not on the card")
    require(img.shape == (FRAME_H, FRAME_W, 3) and np.isfinite(img).all(), "image not finite")
    require(img.mean() > 0.01, f"image is black (mean {img.mean()})")
    require(min(rays) > 0, "no rays traced")
    require(all(v > 0 for v in launches.values()), f"a kernel of the path never launched: {launches}")
    require(overflow == 0, f"traversal stack overflowed {overflow} times")
    ms = 1e3 * float(np.mean(times))
    mrays = float(np.mean(rays)) / float(np.mean(times)) / 1e6
    log(f"[main] {TIMED} frames: {ms:.2f} ms/frame (min {1e3 * min(times):.2f}, max {1e3 * max(times):.2f}), "
        f"{np.mean(rays):.0f} rays/frame, {mrays:.3f} Mrays/s on {smi}; "
        f"image mean {img.mean(axis=(0, 1)).round(4).tolist()}")
    log(f"[main] kernel launches over {WARMUP + TIMED} frames: {launches}")
    return launches, ms, mrays, first


def _render_frames(r, warmup, timed):
    """warmup + timed frames of renderer r, each between two synchronises;
    returns (seconds and rays of the timed frames, frame 0 as (linear
    image, first-hit rnode, first-hit tri, rays))."""
    times, rays, first = [], [], None
    for i in range(warmup + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = r.on_render()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i == 0:
            first = (r.image_linear(), aux["first_rnode"].cpu().numpy(), aux["first_tri"].cpu().numpy(),
                     float(aux["rays"]))
        if i >= warmup:
            times.append(dt)
            rays.append(float(aux["rays"]))
    return times, rays, first


def _require_agree(tag, first, ref):
    """Frame 0 against a reference frame 0 at tests/test_torch_frame.py's
    thresholds, with the same ray count."""
    img, rn, tri, rays = first
    img_r, rn_r, tri_r, rays_r = ref
    ids = ((rn == rn_r) & (tri == tri_r)).mean()
    close = (np.abs(img - img_r) <= 1e-3 * (1 + np.abs(img_r))).all(-1).mean()
    rel = np.abs(img.mean((0, 1)) - img_r.mean((0, 1))) / np.abs(img_r.mean((0, 1)))
    log(f"{tag}: first-hit ids equal {ids:.6f}, pixels within 1e-3 {close:.6f}, channel-mean rel "
        f"diff {rel.max():.2e}, rays {rays:.0f} vs {rays_r:.0f}")
    require(ids >= 0.999 and close >= 0.99 and rel.max() <= 1e-3 and rays == rays_r,
            f"{tag}: frame 0 disagrees")


def material_scenes(tmp):
    """The material phase's scenes, written into tmp: label -> (path, HDR
    path or None, frame size). The HDR is the one helmet_renderer wrote."""
    from vk_gltf_renderer_tpu_torch import scenes

    hdr = os.path.join(tmp, "sky.hdr")
    out = {}
    for label, make, env, size in (("game", scenes.make_game_standin, hdr, (FRAME_W, FRAME_H)),
                                   ("suite", scenes.make_suite_standin, None, SUITE_SIZE),
                                   ("lit_game", scenes.make_lit_game_standin, hdr, (FRAME_W, FRAME_H)),
                                   ("materials", scenes.make_materials_standin, None, (FRAME_W, FRAME_H))):
        d = os.path.join(tmp, label)
        os.makedirs(d, exist_ok=True)
        out[label] = (make(d), env, size)
    return out


def _plane_catcher(r):
    r.use_infinite_plane, r.plane_height, r.plane_shadow_catcher = True, PLANE_HEIGHT, True


def phase_correctness(device, tmp):
    """Kernels on the card vs the plain CPU path on a small frame of the
    helmet, of each material scene, of the foliage stand-in and of the
    helmet over the shadow-catcher plane."""
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    hdr = os.path.join(tmp, "sky.hdr")
    helmet = os.path.join(tmp, "helmet.gltf")
    cases = {"helmet": (helmet, hdr, None)}
    cases.update({label: (path, env, None) for label, (path, env, _) in material_scenes(tmp).items()})
    cases["foliage"] = (foliage_scene(tmp, CHECK_CARDS), hdr, None)
    cases["plane_helmet"] = (helmet, hdr, _plane_catcher)
    out = {}
    for label, (scene, env, setup) in cases.items():
        res = {}
        for dev in (device, "cpu"):
            if label == "foliage":
                r = foliage_renderer(scene, 96, 64, dev)
            else:
                r = GltfRenderer(96, 64, spp=1, max_depth=DEPTH, device=dev)
            if setup is not None:
                setup(r)
            r.create_scene(scene)
            if env is not None:
                r.create_hdr(env)
            aux = r.on_render()
            res[str(dev)] = (r.image_linear(), aux["first_tri"].cpu().numpy(), float(aux["rays"]))
        (img_g, tri_g, rays_g), (img_c, tri_c, rays_c) = res[str(device)], res["cpu"]
        ids = (tri_g == tri_c).mean()
        close = (np.abs(img_g - img_c) <= 1e-3 * (1 + np.abs(img_c))).all(-1).mean()
        rel = np.abs(img_g.mean((0, 1)) - img_c.mean((0, 1))) / np.abs(img_c.mean((0, 1)))
        log(f"[check] {label} 96x64 frame, card vs plain CPU path: first-hit ids equal {ids:.4f}, pixels "
            f"within 1e-3 {close:.4f}, channel-mean rel diff {rel.max():.2e}, rays {rays_g:.0f} vs {rays_c:.0f}")
        require(np.isfinite(img_g).all() and img_g.mean() > 0.01, f"{label}: card frame black or not finite")
        require(ids >= 0.999 and close >= 0.99 and rel.max() <= 1e-3,
                f"{label}: card frame disagrees with the plain path")
        out[label] = dict(ids=float(ids), close=float(close), mean_rel=float(rel.max()), rays=rays_g)
    out.update(_viewer_checks(device, tmp))
    return out


def _guided(r):
    r.denoise_guides, r.animate = True, True


def _upscaled(r):
    r.upscale = 2


def _preview(r, wireframe=False):
    r.render_system, r.wireframe = 1, wireframe


# phase 5's viewer checks: label -> (scene, setup, frames, outputs of the last frame by name)
VIEWER_CHECKS = {
    "guided_brainstem": ("brainstem", _guided, 1, lambda r, aux: {
        **{k: aux[k] for k in ("first_rnode", "spec_albedo", "spec_hitdist", "first_pos_prev", "lum_moments")},
        "image": r.image_linear(), "denoised": r.image_denoised()}),
    "upscale2_helmet": ("helmet", _upscaled, 2, lambda r, aux: {"first_rnode": aux["first_rnode"],
                                                                "taau_history": r._history_hi}),
    "preview_helmet": ("helmet", _preview, 1, lambda r, aux: {"first_rnode": aux["first_rnode"],
                                                              "image": r.image_linear()}),
    "wireframe_helmet": ("helmet", lambda r: _preview(r, True), 1,
                         lambda r, aux: {"first_rnode": aux["first_rnode"], "image": r.image_linear()}),
}


def _viewer_checks(device, tmp):
    """Phase 5's viewer frames at 96x64 on the card against the port's CPU
    path (VIEWER_CHECKS): ids equal on >= 99.9% of pixels, every other
    output within 1e-3 * (1 + |cpu|) on >= 99% of its pixels."""
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.scenes import make_brainstem

    d = os.path.join(tmp, "brainstem_check")
    os.makedirs(d, exist_ok=True)
    scenes = {"brainstem": make_brainstem(d), "helmet": os.path.join(tmp, "helmet.gltf")}
    out = {}
    for label, (scene, setup, frames, outputs) in VIEWER_CHECKS.items():
        res = {}
        for dev in (device, "cpu"):
            r = GltfRenderer(96, 64, spp=1, max_depth=DEPTH, device=dev)
            setup(r)
            r.create_scene(scenes[scene])
            for _ in range(frames):
                aux = r.on_render()
            res[str(dev)] = {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v) for k, v in outputs(r, aux).items()}
        card, cpu = res[str(device)], res["cpu"]
        stats = {}
        for k, ref in cpu.items():
            got = card[k]
            require(got.shape == ref.shape and np.isfinite(got.astype(np.float64)).all(),
                    f"{label}: card {k} has the wrong shape or is not finite")
            if k == "first_rnode":
                stats["ids"] = float((got == ref).mean())
                continue
            px = ref.shape[0] * ref.shape[1] if ref.ndim == 3 else ref.shape[0]
            stats[k] = float((np.abs(got - ref) <= 1e-3 * (1 + np.abs(ref))).reshape(px, -1).all(-1).mean())
        log(f"[check] {label} 96x64 ({frames} frame{'s' if frames > 1 else ''}), card vs plain CPU path: "
            f"first-hit ids equal {stats['ids']:.4f}, share within 1e-3 "
            + ", ".join(f"{k} {v:.4f}" for k, v in stats.items() if k != "ids"))
        require(stats["ids"] >= 0.999 and all(v >= 0.99 for k, v in stats.items() if k != "ids"),
                f"{label}: card frame disagrees with the plain path")
        out[label] = stats
    return out


def terrain_renderer(glb, hdr, device, selection):
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    os.environ["VKGR_PRIMARY_KERNEL"], os.environ["VKGR_PACKET_KERNEL"] = selection
    r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
    t0 = time.perf_counter()
    r.create_scene(glb)
    r.create_hdr(hdr)
    return r, time.perf_counter() - t0


def phase_large_kernels(device, glb, hdr, resources):
    """Every traversal kernel against its plain version on the terrain."""
    from vk_gltf_renderer_tpu_torch.ops.intersect import STACK_CAPACITY

    r, secs = terrain_renderer(glb, hdr, device, SELECTIONS[0])
    wb = r.bvh
    log(f"[large] terrain: {wb.num_world_tris} world tris; create_scene (flatten, SAH, BVH4, hit rows, "
        f"upload) {secs:.1f} s")
    for family, t in _all_tables(r, device).items():
        log(f"[large] {family} table (host build + upload) in {t:.1f} s")
    bvh = r.dev_bvh
    for name in ("nodes4_fi", "tris128", "nodes_fi", "nodes16_fi", "lane_pages", "nodes4_sc", "hit_attr",
                 "nodes4_f", "nodes4_i", "nodes_f", "nodes_i", "nodes_self", "tris"):
        a = getattr(wb, name)
        log(f"[large] {name} {tuple(a.shape)} {a.nbytes / 1e6:.1f} MB")
    log(f"[large] root codes: binary {bvh.root_code}, BVH4 {bvh.root4_code}; stack need "
        f"{bvh.stack_need} of capacity {STACK_CAPACITY}")
    require(set(bvh.stack_need) == set(STACK_CAPACITY), f"stack needs {bvh.stack_need}")
    for family, need in bvh.stack_need.items():
        require(need <= STACK_CAPACITY[family], f"{family} tree needs a {need}-entry stack")

    ro, rd = probe_rays(r, device)
    n = ro.shape[0]
    comps = [ro[:, i].contiguous() for i in range(3)] + [rd[:, i].contiguous() for i in range(3)]
    tmin = torch.zeros(n, device=device)
    g = torch.Generator(device="cpu").manual_seed(99)
    diag = float((bvh.scene_hi - bvh.scene_lo).norm())
    shadow_tmax = (torch.rand(n, generator=g) * diag).to(device)
    far = torch.full((n,), 1e32, device=device)
    sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(5))[:SUBSET].to(device)
    log(f"[large] {n} rays ({n // 2} camera rays at stride 2, {n - n // 2} incoherent); plain "
        f"versions on a fixed subset of {SUBSET}")
    names = ("traverse_bvh2", "traverse_bvh16", "traverse_lanes", "traverse_bvh4") + BVH4_VARIANTS
    results = _run_kernels("large", names, _traversal_runs(bvh), comps, tmin, far, shadow_tmax, sub)
    results["traverse_bvh4"]["against_v7"] = _bvh4_probe_vs_v7("large", bvh, comps, tmin, far, shadow_tmax,
                                                            resources["traverse_bvh4.cu"])
    for name in SAME_TREE:
        results[name]["against_traverse_bvh4"] = _same_tree_probe_vs_bvh4("large", name, bvh, comps, tmin, far,
                                                                          shadow_tmax)
    return results, r, (ro, rd)


def phase_terrain_frames(device, glb, hdr, smi, tmp):
    """The terrain at the bench recipe under each kernel selection."""
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather

    mods = _traversal_modules()
    runs = {}
    r, secs = terrain_renderer(glb, hdr, device, SELECTIONS[0])
    log(f"[terrain] create_scene+create_hdr {secs:.1f} s")
    for selection in SELECTIONS:
        os.environ["VKGR_PRIMARY_KERNEL"], os.environ["VKGR_PACKET_KERNEL"] = selection
        r.frame_idx = 0
        r.reset_frame()
        for m in mods.values():
            m.COUNTER.launches = 0
            m.OVERFLOW.reset()
        tgather.COUNTER.launches = 0
        times, rays, first = _render_frames(r, WARMUP, TERRAIN_TIMED)
        launches = {name: m.COUNTER.launches for name, m in mods.items()}
        dropped = {name: m.OVERFLOW.total() for name, m in mods.items()}
        img = r.image_linear()
        r.save_image(os.path.join(tmp, f"terrain_{selection[0]}_{selection[1]}.png"))
        own = {KERNEL_OF[k] for k in selection}
        require(all((launches[name] > 0) == (name in own) for name in launches),
                f"{selection}: traversal launches {launches}, expected only {sorted(own)}")
        require(tgather.COUNTER.launches > 0, "the HDR gather never launched")
        require(not any(dropped.values()), f"{selection}: dropped work {dropped}")
        require(img.shape == (FRAME_H, FRAME_W, 3) and np.isfinite(img).all() and img.mean() > 0.01,
                f"{selection}: image not finite or black")
        ms = 1e3 * float(np.mean(times))
        mrays = float(np.mean(rays)) / float(np.mean(times)) / 1e6
        log(f"[terrain] {selection}: {TERRAIN_TIMED} frames "
            f"{ms:.2f} ms/frame (min {1e3 * min(times):.2f}, max {1e3 * max(times):.2f}), "
            f"{np.mean(rays):.0f} rays/frame, {mrays:.3f} Mrays/s on {smi}; launches {launches}")
        runs[selection] = dict(ms=ms, mrays=mrays, launches=launches, first=first)

    for selection in SELECTIONS[1:]:
        _require_agree(f"[terrain] frame 0 {selection} vs {SELECTIONS[0]}", runs[selection]["first"],
                       runs[SELECTIONS[0]]["first"])
    for k in ("VKGR_PRIMARY_KERNEL", "VKGR_PACKET_KERNEL"):
        os.environ.pop(k, None)
    return runs


def _camera_rays(r, device):
    """The camera rays of every pixel of frame 0 (pixel centres), [N,3]."""
    from vk_gltf_renderer_tpu_torch.ops.camera import generate_rays

    fr = r._frame_inputs()
    xs, ys = torch.meshgrid(torch.arange(FRAME_W, device=device), torch.arange(FRAME_H, device=device),
                            indexing="xy")
    pos = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float()
    return generate_rays(pos, torch.full_like(pos, 0.5),
                         torch.tensor([FRAME_W, FRAME_H], dtype=torch.float32, device=device),
                         fr["proj_inv"], fr["view_inv"])


def phase_megakernel(device, scenes, smi):
    """The megakernel A/B on the camera rays of frame 0 of each scene."""
    from vk_gltf_renderer_tpu_torch.ops import megakernel as mk
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4

    results = {}
    for label, r in scenes:
        ro, rd = (a.cpu().numpy() for a in _camera_rays(r, device))
        n = ro.shape[0]
        seeds = np.random.default_rng(42).integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
        packed = mk.pack_rays(ro, rd, seeds, device=device)[:3]
        sub = np.sort(np.random.default_rng(6).permutation(n)[:SUBSET])
        sub_packed = mk.pack_rays(ro[sub], rd[sub], seeds[sub], device=device)[:3]
        bvh = r.dev_bvh
        tables = (bvh.nodes4_fi, bvh.tris128)
        for depth in MEGA_DEPTHS:
            def mega(p=packed, d=depth):
                return mk.render_mega(*tables, *p, d, bvh.root4_code)

            def wave(p=packed, d=depth):
                return mk.render_wavefront(*tables, *p, d, bvh.root4_code)

            mk.COUNTER.launches = 0
            tb4.COUNTER.launches = 0
            mk.OVERFLOW.reset()
            tb4.OVERFLOW.reset()
            mega_ms = device_ms(mega, 5)
            wave_ms = device_ms(wave, 5)
            launches = {"render_mega": mk.COUNTER.launches, "traverse_bvh4": tb4.COUNTER.launches}
            require(launches["render_mega"] == 6 and launches["traverse_bvh4"] == 6 * depth,
                    f"{label} depth {depth}: launches {launches}")
            out_m, out_w = mega(), wave()
            require(mk.OVERFLOW.total() == 0 and tb4.OVERFLOW.total() == 0, "the megakernel dropped pushes")
            # one walk in both arms: equal-t ties resolve alike, so every ray is equal
            differ = int((out_m != out_w).any(dim=1).sum())
            require(differ == 0, f"{label} depth {depth}: mega and wavefront differ on {differ} rays")
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = mk.render_mega_plain(*tables, *sub_packed, depth, bvh.root4_code, stats=stats)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            k = mk.render_mega(*tables, *sub_packed, depth, bvh.root4_code)
            real = torch.arange(k.shape[0] * k.shape[2] * k.shape[3], device=device) < SUBSET
            k, plain = (x.transpose(0, 1).reshape(2, -1)[:, real] for x in (k, plain))
            err = float((k - plain).abs().max())
            require(torch.equal(k[0], plain[0]) and bool(((k[1] - plain[1]).abs()
                                                          <= 1e-5 * (1 + plain[1].abs())).all()),
                    f"{label} depth {depth}: mega and its plain version differ (max err {err})")
            ended = stats["ended"]
            require(sum(ended) == SUBSET, f"{label} depth {depth}: {ended} paths ended of {SUBSET}")
            table_bytes, flops, visits = _visits(stats, 4, 128)
            ray_bytes = (4 + 4 + 1 + 2) * 4  # ro, rd, seed in; radiance, t out
            b_ms, b_by = bound(table_bytes + n * ray_bytes, flops * n / SUBSET + n * depth * SHADE_FLOPS)
            rad = out_m[:, 0].reshape(-1)[:n]
            require(bool(torch.isfinite(out_m).all()) and float(rad.max()) > 0, "megakernel output")
            log(f"[mega] {label} depth {depth}, {n} camera rays: render_mega {mega_ms:.3f} ms "
                f"({n * depth / mega_ms / 1e3:.1f} Mrays/s), render_wavefront {wave_ms:.3f} ms "
                f"({n * depth / wave_ms / 1e3:.1f} Mrays/s), wavefront/mega {wave_ms / mega_ms:.2f}x on "
                f"{smi}; equal on every ray; plain {plain_ms:.1f} ms for {SUBSET} rays, max err {err:.3g}, "
                f"paths ended at bounces 0..{depth - 1}: {ended}; "
                f"visits on the subset {visits}; bound {b_ms:.4f} ms ({b_by}); mean radiance "
                f"{float(rad.mean()):.4f}; launches {launches}")
            results[(label, depth)] = dict(ms=mega_ms, wavefront_ms=wave_ms, plain_ms=plain_ms,
                                           max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                                           launches=launches["render_mega"], rays=n, ended_subset=ended)
    return results


def phase_split_kernels(device, label, r, ro, rd):
    """The packet4 and v1 kernels on renderer r's scene (its split tables
    uploaded by _all_tables) and probe rays ro, rd."""
    from vk_gltf_renderer_tpu_torch.ops import traverse as tt
    from vk_gltf_renderer_tpu_torch.ops.intersect import STACK_CAPACITY, intersect_rays_packet

    bvh = r.dev_bvh
    mods = _traversal_modules()
    n = ro.shape[0]
    comps = [ro[:, i].contiguous() for i in range(3)] + [rd[:, i].contiguous() for i in range(3)]
    tmin = torch.zeros(n, device=device)
    far = torch.full((n,), 1e32, device=device)
    g = torch.Generator(device="cpu").manual_seed(99)
    shadow_tmax = (torch.rand(n, generator=g) * float((bvh.scene_hi - bvh.scene_lo).norm())).to(device)
    sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(5))[:SUBSET].to(device)
    log(f"[split] {label}: {n} rays, plain versions on a fixed subset of {SUBSET}; tables "
        + ", ".join(f"{k} {tuple(getattr(bvh, k).shape)} {getattr(bvh, k).numel() * 4 / 1e6:.1f} MB"
                    for k in ("nodes4_f", "nodes4_i", "nodes_f", "nodes_i", "tris", "wtri_rnode")))
    kernels = {"traverse_bvh4_split": (tt.traverse_bvh4_split_plain, (bvh.nodes4_f, bvh.nodes4_i, bvh.tris), {}),
               "traverse_bvh2_split": (tt.traverse_bvh2_split_plain, (bvh.nodes_f, bvh.nodes_i, bvh.tris),
                                       {"root_leaf": bvh.bvh2_split_root_leaf})}
    results = {}
    for name, (plain, tables, fkw) in kernels.items():
        family, kw, arity, row_bytes = SPLIT[name]
        mod = mods[name]
        need, cap = bvh.stack_need[family], STACK_CAPACITY[family]
        require(need <= cap, f"{name}: the tree needs a {need}-entry stack of {cap}")
        mod.OVERFLOW.reset()
        args = (*comps, tmin, far)
        fn = getattr(mod, name)
        ms = device_ms(lambda: fn(*tables, *args, **fkw), 10)
        entry_ms = device_ms(lambda: intersect_rays_packet(bvh, ro, rd, tmin, far, **kw), 10)
        any_ms = device_ms(lambda: intersect_rays_packet(bvh, ro, rd, tmin, shadow_tmax, anyhit=True, **kw), 10)
        # the entry point's run: one closest-hit and one anyhit=True call
        mod.COUNTER.launches = 0
        closest = intersect_rays_packet(bvh, ro, rd, tmin, shadow_tmax, **kw)
        anyhit = intersect_rays_packet(bvh, ro, rd, tmin, shadow_tmax, anyhit=True, **kw)
        launches = mod.COUNTER.launches
        require(launches == 2, f"{name}: {launches} launches for two intersect_rays_packet calls")
        require(all(torch.equal(closest[k], anyhit[k]) for k in closest),
                f"{name}: anyhit=True differs from the closest hit")
        sargs = tuple(a[sub].contiguous() for a in args)
        k = fn(*tables, *sargs, **fkw)
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = plain(*tables, *sargs, stats=stats)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = _check_against_plain(name, k, p, SUBSET, False)  # ids: tris rows
        require(mod.OVERFLOW.total() == 0, f"{name}: the kernel dropped {mod.OVERFLOW.total()} pushes")
        b_ms, b_by, visits = traversal_bound(stats, arity, row_bytes, n, SUBSET, SPLIT_LEAF_BYTES)
        hits = int((closest["tri"] >= 0).sum())
        log(f"[split] {label} {name}: kernel {ms:.3f} ms closest hit for {n} rays ({n / ms / 1e3:.1f} "
            f"Mrays/s), through intersect_rays_packet {entry_ms:.3f} ms, anyhit=True {any_ms:.3f} ms and "
            f"equal to the closest hit on every ray ({hits} hits within the shadow segments); plain "
            f"{plain_ms:.1f} ms for {SUBSET} rays; stack need {need} of {cap}; visits {visits}; bound "
            f"{b_ms:.4f} ms ({b_by})")
        results[name] = dict(ms=ms, entry_ms=entry_ms, anyhit_ms=any_ms, plain_ms=plain_ms,
                             max_abs_err=err, bound_ms=b_ms, bound_by=b_by, rays=n, plain_rays=SUBSET,
                             stack_need=need, launches=launches)
    return results


def phase_packet4_frames(device, scenes, smi):
    """VKGR_TRAVERSAL=packet4 at the bench recipe; scenes: (label, scene
    path, hdr path, the (v3, v9) frame 0)."""
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    mods = _traversal_modules()
    runs = {}
    os.environ["VKGR_TRAVERSAL"] = "packet4"
    for label, path, hdr, ref in scenes:
        r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
        t0 = time.perf_counter()
        r.create_scene(path)
        r.create_hdr(hdr)
        secs = time.perf_counter() - t0
        for m in mods.values():
            m.COUNTER.launches = 0
            m.OVERFLOW.reset()
        tgather.COUNTER.launches = 0
        times, rays, first = _render_frames(r, WARMUP, PACKET4_TIMED)
        launches = {name: m.COUNTER.launches for name, m in mods.items()}
        dropped = {name: m.OVERFLOW.total() for name, m in mods.items()}
        require(all((v > 0) == (k == "traverse_bvh4_split") for k, v in launches.items()),
                f"packet4 {label}: traversal launches {launches}, expected only traverse_bvh4_split")
        require(tgather.COUNTER.launches > 0, "the HDR gather never launched")
        require(not any(dropped.values()), f"packet4 {label}: dropped work {dropped}")
        img = r.image_linear()
        require(np.isfinite(img).all() and img.mean() > 0.01, f"packet4 {label}: image not finite or black")
        ms = 1e3 * float(np.mean(times))
        mrays = float(np.mean(rays)) / float(np.mean(times)) / 1e6
        log(f"[packet4] {label}: create_scene+create_hdr {secs:.1f} s; {PACKET4_TIMED} frames {ms:.2f} ms/frame "
            f"(min {1e3 * min(times):.2f}, max {1e3 * max(times):.2f}), {np.mean(rays):.0f} rays/frame, "
            f"{mrays:.3f} Mrays/s on {smi}; launches {launches['traverse_bvh4_split']} of "
            f"traverse_bvh4_split, {tgather.COUNTER.launches} of gather_channels")
        _require_agree(f"[packet4] {label} frame 0 vs (v3, v9)", first, ref)
        recorded, aux = record_launches(r, "traverse_bvh4_split")
        runs[label] = dict(ms=ms, mrays=mrays, launches=launches["traverse_bvh4_split"],
                           replay=_replay_packet4(device, label, r.dev_bvh, recorded, aux, smi))
        del r, recorded
    os.environ.pop("VKGR_TRAVERSAL")
    return runs


def _replay_packet4(device, label, bvh, recorded, aux, smi):
    """Phase 7b for packet4: each recorded launch of one packet4 frame
    timed beside traverse_bvh4 (closest hit, the same lanes), against the
    plain version on a fixed subset of SUBSET lanes (dead lanes included),
    with its bound. Nothing may be dropped. Returns dict(frame, launches)."""
    from vk_gltf_renderer_tpu_torch.ops import traverse as tt
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4_split as tb4s

    name = "traverse_bvh4_split"
    require(0 < len(recorded) <= 2 * DEPTH, f"packet4 {label}: {len(recorded)} {name} launches")
    tables = (bvh.nodes4_f, bvh.nodes4_i, bvh.tris)
    _, _, arity, row_bytes = SPLIT[name]
    tb4s.OVERFLOW.reset()
    launches = []
    for k, (rays, _) in enumerate(recorded):
        n = rays[0].shape[0]
        live = int((rays[7] >= 0).sum())
        times = _beside_bvh4(bvh, name, lambda *a, anyhit: tb4s.traverse_bvh4_split(*tables, *a), rays, False)
        sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(70 + k))[:SUBSET]
        sargs = tuple(a[sub.to(device)].contiguous() for a in rays)
        stats = {}
        err = _check_against_plain(name, tb4s.traverse_bvh4_split(*tables, *sargs),
                                   tt.traverse_bvh4_split_plain(*tables, *sargs, stats=stats), SUBSET, False)
        b_ms, b_by, visits = traversal_bound(stats, arity, row_bytes, n, SUBSET, SPLIT_LEAF_BYTES, n_dead=n - live)
        log(f"[replay] packet4 {label} launch {k}: {n} lanes, {live} live ({100 * live / n:.2f}%): {name} "
            f"{times[name]:.4f} ms, traverse_bvh4 {times['traverse_bvh4']:.4f} ms on the same lanes (t differs "
            f"on {times['t_differs']}); bound {b_ms:.4f} ms ({b_by}); plain on {SUBSET} lanes "
            f"({int((sargs[7] >= 0).sum())} live), max err {err:.3g}; visits {visits}")
        launches.append(dict(hit="closest", lanes=n, live=live, ms=times[name], traverse_bvh4=times["traverse_bvh4"],
                             t_differs=times["t_differs"], bound_ms=b_ms, max_abs_err=err))
    dropped = tb4s.OVERFLOW.total()
    require(dropped == 0, f"{name}: the replay dropped {dropped} (stack overflow / bad link)")
    frame = {key: sum(x[key] for x in launches) for key in ("ms", "traverse_bvh4", "bound_ms", "live")}
    frame.update(rays=float(aux["rays"]), traverse_bvh4_ms=frame.pop("traverse_bvh4"))
    log(f"[replay] packet4 {label} frame ({len(launches)} launches, {frame['live']} live lanes; the frame "
        f"counted {frame['rays']:.0f} rays): {name} {frame['ms']:.4f} ms, traverse_bvh4 on the same lanes "
        f"{frame['traverse_bvh4_ms']:.4f} ms, bound {frame['bound_ms']:.4f} ms, on {smi}")
    return dict(frame=frame, launches=launches)


def phase_wavefront_frame(device, path, hdr, smi):
    """VKGR_TRAVERSAL=wavefront on the helmet at the largest size whose
    frame is predicted under WAVEFRONT_FRAME_S from a 480x270 frame (its
    time scaled by pixel count)."""
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    def renderer(w, h):
        r = GltfRenderer(w, h, spp=SPP, max_depth=DEPTH, device=device)
        r.create_scene(path)
        r.create_hdr(hdr)
        return r

    mods = _traversal_modules()
    for m in mods.values():
        m.COUNTER.launches = 0
    os.environ["VKGR_TRAVERSAL"] = "wavefront"
    w0, h0 = WAVEFRONT_SIZES[-1]
    r = renderer(w0, h0)
    (t_size,), _, first = _render_frames(r, 0, 1)
    w, h = next(((w, h) for w, h in WAVEFRONT_SIZES if t_size * w * h / (w0 * h0) <= WAVEFRONT_FRAME_S),
                WAVEFRONT_SIZES[-1])
    log(f"[wavefront] helmet {w0}x{h0} sizing frame {t_size:.2f} s: rendering at {w}x{h}")
    if (w, h) == (w0, h0):  # the sizing frame is the timed frame
        times, rays = [t_size], [first[3]]
    else:
        r = renderer(w, h)
        times, rays, first = _render_frames(r, 1, 1)
    launches = {name: m.COUNTER.launches for name, m in mods.items()}
    os.environ.pop("VKGR_TRAVERSAL")
    require(not any(launches.values()), f"wavefront: traversal kernels launched {launches}")
    img = r.image_linear()
    require(np.isfinite(img).all() and img.mean() > 0.01, "wavefront: image not finite or black")
    log(f"[wavefront] helmet {w}x{h} spp {SPP} depth {DEPTH}: 1 frame {times[0]:.2f} s, {rays[0]:.0f} rays, "
        f"{rays[0] / times[0] / 1e6:.3f} Mrays/s on {smi}; no traversal kernel launched")
    _, _, ref = _render_frames(renderer(w, h), 1, 0)
    _require_agree(f"[wavefront] helmet {w}x{h} frame 0 vs (v3, v9)", first, ref)
    return dict(ms=1e3 * times[0], size=f"{w}x{h}", sizing_s=t_size, mrays=rays[0] / times[0] / 1e6)


def _plain_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_probes(device):
    """The node-fetch and visit probes through their run() entries, then
    every run against its plain version."""
    from vk_gltf_renderer_tpu_torch.probes import nodefetch as nf
    from vk_gltf_renderer_tpu_torch.probes import visit as vs

    nf.COUNTER.launches = 0
    vs.COUNTER.launches = 0
    nf_runs = nf.run(device, visits=PROBE_VISITS)
    vs_runs = vs.run(device, visits=PROBE_VISITS)
    launches = {"probe_nodefetch": nf.COUNTER.launches, "probe_visit": vs.COUNTER.launches}
    require(all(v > 0 for v in launches.values()), f"a probe never launched: {launches}")
    results = {"probe_nodefetch": {"runs": {}}, "probe_visit": {"runs": {}}}
    for run in nf_runs:
        tab, start, rox = run["inputs"]
        stats = {}
        plain, plain_ms = _plain_ms(lambda: nf.probe_nodefetch_plain(*run["inputs"], run["visits"], stats=stats))
        require(torch.equal(run["out"], plain), f"probe_nodefetch {run['label']}: kernel and plain differ")
        err = float((run["out"].double() - plain.double()).abs().max())
        n = rox.numel()
        rows = int(stats["rows"].sum())
        b_ms, b_by = bound(rows * nf.ROW_BYTES + n * 4 * 2 + start.numel() * 4, n * run["visits"] * 8)
        log(f"[probe] nodefetch {run['label']}: table {tuple(tab.shape)} ({tab.numel() * 4 / 1e6:.1f} MB), "
            f"{start.numel()} chains x {run['visits']} visits in blocks of {run['block']} threads, {rows} "
            f"distinct rows: {run['ms']:.3f} ms, "
            f"{run['ns']:.1f} ns per dependent visit; equal to plain ({plain_ms:.1f} ms); bound "
            f"{b_ms:.4f} ms ({b_by})")
        results["probe_nodefetch"]["runs"][run["label"]] = dict(ms=run["ms"], ns_per_visit=run["ns"],
                                                                plain_ms=plain_ms, max_abs_err=err,
                                                                bound_ms=b_ms, bound_by=b_by)
    for run in vs_runs:
        fi, sc, ro = run["inputs"]
        stats = {}
        plain, plain_ms = _plain_ms(lambda: vs.probe_visit_plain(*run["inputs"], run["visits"], run["variant"],
                                                                 stats=stats))
        require(torch.equal(run["out"], plain), f"probe_visit {run['variant']}: kernel and plain differ")
        err = float((run["out"].double() - plain.double()).abs().max())
        ways = vs.VARIANTS[run["variant"]]
        rows = int(stats["rows"].sum())
        lanes = ro.shape[0] * vs.SUB * vs.LANE
        b_ms, b_by = bound(rows * (128 + 32) + lanes * 4 * (3 + 1),
                           lanes * (run["visits"] // ways) * 4 * BOX_FLOPS)
        log(f"[probe] visit {run['variant']} ({ways} chain(s) per packet, {ro.shape[0]} packets, "
            f"{run['visits']} visits, {rows} distinct rows): {run['ms']:.3f} ms, {run['ns']:.1f} ns per visit, "
            f"{run['ns_step']:.1f} ns per dependent step; equal to plain ({plain_ms:.1f} ms); bound "
            f"{b_ms:.4f} ms ({b_by})")
        results["probe_visit"]["runs"][run["variant"]] = dict(ms=run["ms"], ns_per_visit=run["ns"],
                                                              ns_per_step=run["ns_step"], plain_ms=plain_ms,
                                                              max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
    for name, first in (("probe_nodefetch", "variant a"), ("probe_visit", "a")):
        runs = results[name]["runs"]
        head = runs[first]
        results[name].update(launches=launches[name], library_ms=None,
                             max_abs_err=max(v["max_abs_err"] for v in runs.values()),
                             **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    return results


UARCH_FLOPS = {"empty": 0, "vec1": 2, "gather": 1, "gather12": 13, "reduce": 2, "dynslice": 1,
               "depchain": 2, "dynslice128": 1}  # float ops per element and step
STREAM_HEAD = "C tma TPU size"  # the stream probe's run in the kernels line's own keys


def phase_stream_uarch(device):
    """The stream-copy and micro-op probes through their run() entries,
    then every run against its plain version (the micro-ops' on CPU copies
    of their inputs) and, for the regular page order, against the
    library's index_select + sum."""
    from vk_gltf_renderer_tpu_torch.probes import stream_dma as sd
    from vk_gltf_renderer_tpu_torch.probes import uarch as ua

    sd.COUNTER.launches = 0
    ua.COUNTER.launches = 0
    sd_runs = sd.run(device)
    ua_runs = ua.run(device)
    launches = {"probe_stream_dma": sd.COUNTER.launches, "probe_uarch": ua.COUNTER.launches}
    require(all(v > 0 for v in launches.values()), f"a probe never launched: {launches}")
    results = {"probe_stream_dma": {"runs": {}}, "probe_uarch": {"runs": {}}}
    head = {}
    for run in sd_runs:
        tab, v, blocks, steps = run["tab"], run["variant"], run["blocks"], run["steps"]
        stats = {}
        plain, plain_ms = _plain_ms(lambda: sd.probe_stream_dma_plain(tab, v, blocks, steps, stats=stats))
        require(torch.equal(run["out"], plain), f"probe_stream_dma {run['label']}: kernel and plain differ")
        err = float((run["out"].double() - plain.double()).abs().max())
        f = sd.fields_of(v)
        page_bytes = f * sd.LANE * 4
        dyn, _ = sd.order_of(v)
        pages = int(stats["pages"].sum())
        b_ms, b_by = bound((pages + blocks) * page_bytes, blocks * steps * f * sd.LANE * (2 if dyn else 1))
        lib_ms = None
        if not dyn:
            idx = sd.regular_pages(tab.shape[0] // f, blocks, steps, device).reshape(-1)

            def lib():
                return tab.view(-1, f, sd.LANE).index_select(0, idx).view(blocks, steps, f, sd.LANE).sum(1)

            require(torch.equal(lib().reshape(plain.shape), plain), f"index_select + sum {run['label']} differs")
            lib_ms = device_ms(lib, 5)
        log(f"[stream] {run['label']}: {blocks} x {steps} pages of {page_bytes} B, {pages} distinct: "
            f"{run['ms']:.4f} ms, {run['us_page']:.3f} us per page, {run['gbs']:.1f} GB/s; equal to plain "
            f"({plain_ms:.1f} ms)" + (f" and to index_select + sum ({lib_ms:.4f} ms)" if lib_ms else "")
            + f"; bound {b_ms:.5f} ms ({b_by})")
        # the JSON line keeps [ms, us per page, GB/s, max_abs_err]; plain, bound and library times are in
        # the log line
        results["probe_stream_dma"]["runs"][run["label"]] = [run["ms"], run["us_page"], run["gbs"], err]
        if run["label"] == STREAM_HEAD:
            head = dict(plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    for run in ua_runs:
        op, (a, b) = run["op"], run["inputs"]
        stats = {}
        t0 = time.perf_counter()
        plain = ua.probe_uarch_plain(op, a.cpu(), b.cpu(), run["iters"], stats=stats)
        plain_ms = (time.perf_counter() - t0) * 1e3
        require(torch.equal(run["out"].cpu(), plain), f"probe_uarch {op}: kernel and plain differ")
        err = float((run["out"].cpu().double() - plain.double()).abs().max())
        row_bytes = b.shape[1] * 4 if op == "dynslice128" else 4  # dynslice reads one word a row
        b_ms, b_by = bound(2 * a.numel() * 4 + stats["rows"] * row_bytes,
                           a.numel() * run["iters"] * UARCH_FLOPS[op])
        log(f"[uarch] {op}: {run['iters']} steps: {run['ms']:.4f} ms, {run['ns']:.2f} ns and "
            f"{run['cycles']:.2f} SM cycles per step ({run['cycles'] / run['ns']:.3f} GHz); equal to plain "
            f"on the CPU ({plain_ms:.0f} ms); bound {b_ms:.6f} ms ({b_by})")
        results["probe_uarch"]["runs"][op] = dict(ms=run["ms"], ns_per_step=run["ns"],
                                                  cycles_per_step=run["cycles"], plain_ms=plain_ms,
                                                  plain_device="cpu", max_abs_err=err, bound_ms=b_ms,
                                                  bound_by=b_by)
    stream = results["probe_stream_dma"]
    stream.update(launches=launches["probe_stream_dma"], headline=STREAM_HEAD,
                  max_abs_err=max(r[3] for r in stream["runs"].values()),
                  ms=stream["runs"][STREAM_HEAD][0], runs_fields=["ms", "us_per_page", "gb_per_s", "max_abs_err"],
                  library="tab.view(-1,F,128).index_select(0, idx).sum over steps", **head)
    uarch = results["probe_uarch"]
    uarch.update(launches=launches["probe_uarch"], headline="depchain", library_ms=None,
                 max_abs_err=max(r["max_abs_err"] for r in uarch["runs"].values()),
                 **{k: uarch["runs"]["depchain"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    return results


def _headless_record(out):
    """The BENCHMARK_JSON record of a headless run's stdout."""
    lines = [ln for ln in out.splitlines() if ln.startswith("BENCHMARK_JSON ")]
    require(len(lines) == 1, f"headless printed {len(lines)} BENCHMARK_JSON lines")
    return lines[0], json.loads(lines[0].split(" ", 1)[1])


def phase_frontends(device, tmp, glb, smi):
    """Phase 14: headless, the benchmark harness, the bench entry and the
    frame profiler on the card."""
    import io
    from contextlib import redirect_stdout

    from vk_gltf_renderer_tpu_torch import headless
    from vk_gltf_renderer_tpu_torch.benchmark.__main__ import main as benchmark_main
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.utils.png import read_png
    from vk_gltf_renderer_tpu_torch.utils.profiler import format_table, profile_frames

    for key in ("VKGR_PRIMARY_KERNEL", "VKGR_PACKET_KERNEL", "VKGR_TRAVERSAL"):
        os.environ.pop(key, None)
    os.environ["VKGR_SETTINGS"] = os.path.join(tmp, "settings.json")
    scene, hdr = os.path.join(tmp, "helmet.gltf"), os.path.join(tmp, "sky.hdr")
    png = os.path.join(tmp, "headless.png")
    t0 = time.perf_counter()
    tb4.COUNTER.launches = 0
    tgather.COUNTER.launches = 0
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = headless.main(["--headless", "--scenefile", scene, "--hdrfile", hdr, "--envSystem", "1",
                            "--size", str(FRAME_W), str(FRAME_H), "--frames", "6", "--output", png])
    launches = {"traverse_bvh4": tb4.COUNTER.launches, "gather_channels": tgather.COUNTER.launches}
    line, rec = _headless_record(buf.getvalue())
    log(f"[frontends] headless rc {rc}: {line}")
    with open(png, "rb") as f:
        img = read_png(f.read())
    log(f"[frontends] headless PNG {img.shape}, mean {img.mean(axis=(0, 1)).round(2).tolist()}; kernel "
        f"launches {launches} ({time.perf_counter() - t0:.1f} s)")
    require(rc == 0 and rec["frames"] == 5 and rec["triangles"] == 9218 and rec["Mrays_per_sec"] > 0,
            f"headless record {rec}")
    require(img.shape == (FRAME_H, FRAME_W, 3) and img.mean() > 1, "headless PNG is wrong or black")
    require(all(v > 0 for v in launches.values()), f"a kernel of the headless path never launched: {launches}")

    t0 = time.perf_counter()
    cfg, csv_path = os.path.join(tmp, "frontends.cfg"), os.path.join(tmp, "frontends.csv")
    with open(cfg, "w") as f:
        for path in (scene, glb):
            f.write(f"--scenefile {path} --size 512 512 --frames 4 --envSystem 1 --hdrfile {hdr}\n")
    with redirect_stdout(io.StringIO()):
        rc_run = benchmark_main(["run", cfg, "--output", csv_path, "--device", str(device)])
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc_cmp = benchmark_main(["compare", csv_path, csv_path])
    with open(csv_path) as f:
        rows = f.read().splitlines()
    log(f"[frontends] benchmark run rc {rc_run}, compare rc {rc_cmp} ({time.perf_counter() - t0:.1f} s); "
        f"CSV: {rows}; compare: {buf.getvalue().splitlines()}")
    require(rc_run == 0 and rc_cmp == 0 and len(rows) == 3, "benchmark run / compare failed")

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items() if not k.startswith("VKGR_BENCH_")}
    env["VKGR_BENCH_SCENE2_TIMEOUT"] = "300"
    env["VKGR_BENCH_FRAMES"] = str(BENCH_CHILD_FRAMES)
    proc = subprocess.run([sys.executable, "-m", "vk_gltf_renderer_tpu_torch.bench_impl"], cwd=str(ROOT),
                          env=env, capture_output=True, text=True, timeout=400)
    bench_line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    log(f"[frontends] bench_impl rc {proc.returncode} ({time.perf_counter() - t0:.1f} s): {bench_line}")
    require(proc.returncode == 0, f"bench_impl failed: {proc.stderr[-2000:]}")
    bench = json.loads(bench_line)
    require(bench["value"] > 0 and "error" not in bench["detail"].get("scene2", {"error": "missing"}),
            "bench_impl reported no rate or an error")

    profiles = {}
    for label, path in (("helmet", scene), ("terrain", glb)):
        t0 = time.perf_counter()
        r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
        r.create_scene(path)
        r.create_hdr(hdr)
        profiles[label] = profile_frames(r, PROFILED_FRAMES)
        del r
        log(format_table(profiles[label], f"[frontends] profile {label} {FRAME_W}x{FRAME_H} on {smi}, "))
        log(f"[frontends] profile {label} took {time.perf_counter() - t0:.1f} s")
    return dict(headless=rec, launches=launches, bench=bench, profiles=profiles)


def _scene_tables(r):
    """Triangles and table sizes of renderer r's scene (PERF.md section 4)."""
    b = r.dev_bvh
    return dict(world_tris=int(b.num_world_tris), nodes4_rows=int(b.nodes4_fi.shape[0]),
                tris128_rows=int(b.tris128.shape[0]), hit_attr_rows=int(b.hit_attr.shape[0]),
                hit_attr_cols=int(b.hit_attr.shape[1]),
                table_mb=round(sum(t.numel() * t.element_size() for t in (b.nodes4_fi, b.tris128, b.hit_attr))
                               / 1e6, 3),
                materials=int(r.dev_scene.mat_packed.shape[0]), lights=int(r.dev_scene.num_lights))


def _count_bvh4_calls():
    """Wrap ops.intersect.traverse_bvh4 to count its calls by hit mode;
    returns (counts dict, restore function)."""
    from vk_gltf_renderer_tpu_torch.ops import intersect

    counts = {"closest": 0, "any": 0}
    traced = intersect.traverse_bvh4

    def counted(*args, **kw):
        counts["any" if kw.get("anyhit", False) else "closest"] += 1
        return traced(*args, **kw)

    intersect.traverse_bvh4 = counted
    return counts, lambda: setattr(intersect, "traverse_bvh4", traced)


def phase_material_frames(device, scenes, smi):
    """Phase 15a: the material scenes through the entry points, 2 warm-up
    and MATERIAL_TIMED timed frames each between two synchronizes: ms/frame,
    Mrays/s and the kernels' launches a frame (traverse_bvh4 closest and
    any hit apart, from a count of its wrapper's calls held equal to the
    kernel's launch counter); the MATERIAL_PROFILED scenes then through
    profile_frames."""
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.utils.profiler import format_table, profile_frames

    for key in ("VKGR_PRIMARY_KERNEL", "VKGR_PACKET_KERNEL", "VKGR_TRAVERSAL"):
        os.environ.pop(key, None)
    results = {}
    for label in MATERIAL_FRAMES:
        path, hdr, (w, h) = scenes[label]
        t0 = time.perf_counter()
        r = GltfRenderer(w, h, spp=SPP, max_depth=DEPTH, device=device)
        r.create_scene(path)
        if hdr is not None:
            r.create_hdr(hdr)
        cfg = r._config()
        tables = _scene_tables(r)
        log(f"[materials] {label} {w}x{h} spp {SPP} depth {DEPTH}, env {cfg.env_kind}, features "
            f"{sorted(cfg.features)}, lights {tables['lights']}; tables {tables} "
            f"(built in {time.perf_counter() - t0:.1f} s)")
        tb4.COUNTER.launches = 0
        tgather.COUNTER.launches = 0
        tb4.OVERFLOW.reset()
        calls, restore = _count_bvh4_calls()
        try:
            times, rays, first = _render_frames(r, WARMUP, MATERIAL_TIMED)
        finally:
            restore()
        frames = WARMUP + MATERIAL_TIMED
        launches = {"traverse_bvh4": tb4.COUNTER.launches, "gather_channels": tgather.COUNTER.launches}
        img = r.image_linear()
        require(img.shape == (h, w, 3) and np.isfinite(img).all() and img.mean() > 0.01,
                f"{label}: image black or not finite (mean {img.mean()})")
        require(min(rays) > 0 and tb4.OVERFLOW.total() == 0, f"{label}: no rays, or the stack overflowed")
        require(launches["traverse_bvh4"] == calls["closest"] + calls["any"] > 0,
                f"{label}: traverse_bvh4 launches {launches} against wrapper calls {calls}")
        require((launches["gather_channels"] > 0) == (hdr is not None),
                f"{label}: gather_channels launches {launches['gather_channels']} under env {cfg.env_kind}")
        ms = 1e3 * float(np.mean(times))
        mrays = float(np.mean(rays)) / float(np.mean(times)) / 1e6
        per_frame = {"traverse_bvh4_closest": calls["closest"] / frames, "traverse_bvh4_any": calls["any"] / frames,
                     "gather_channels": launches["gather_channels"] / frames}
        log(f"[materials] {label} {MATERIAL_TIMED} frames: {ms:.2f} ms/frame (min {1e3 * min(times):.2f}, max "
            f"{1e3 * max(times):.2f}), {np.mean(rays):.0f} rays/frame, {mrays:.3f} Mrays/s on {smi}; launches a "
            f"frame {per_frame}; image mean {img.mean(axis=(0, 1)).round(4).tolist()}")
        results[label] = dict(size=f"{w}x{h}", env=cfg.env_kind, ms=ms, min_ms=1e3 * min(times),
                              max_ms=1e3 * max(times), mrays=mrays, rays=float(np.mean(rays)),
                              launches=launches, per_frame=per_frame, tables=tables)
        if label in MATERIAL_PROFILED:
            prof = profile_frames(r, PROFILED_FRAMES)
            log(format_table(prof, f"[materials] profile {label} {w}x{h} on {smi}, "))
            results[label]["profile"] = {k: prof[k] for k in ("kernel_ms_per_frame", "launches_per_frame",
                                                              "wall_ms_per_frame", "busy_share")}
        del r
    return results


def phase_march_replay(device, scenes, smi):
    """Phase 15b: the transmission march's launches on their own. One 1080p
    frame of each MARCH_REPLAYS scene through on_render with
    ops.intersect.traverse_bvh4 recorded; the march's launches are its
    closest-hit launches with tmin 1e-4 (the primary and bounce traces start
    at 0). Each is replayed through traverse_bvh4 and its plain version on
    every lane, timed with CUDA events, with its bound. t, rnode and tri must equal the plain walk's bit
    for bit on every lane, u and v on every hit."""
    from vk_gltf_renderer_tpu_torch.ops import traverse as tt
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    results = {}
    for label in MARCH_REPLAYS:
        path, hdr, (w, h) = scenes[label]
        r = GltfRenderer(w, h, spp=SPP, max_depth=DEPTH, device=device)
        r.create_scene(path)
        if hdr is not None:
            r.create_hdr(hdr)
        recorded, aux = record_launches(r, "traverse_bvh4")
        march = [rays for rays, anyhit in recorded if not anyhit and bool((rays[6] > 0).all())]
        require(march, f"{label}: no transmission-march launch in a frame")
        bvh = r.dev_bvh
        tables = (bvh.nodes4_fi, bvh.tris128, bvh.root4_code)
        launches = []
        for k, rays in enumerate(march):
            n = rays[0].shape[0]
            live = int((rays[7] >= 0).sum())
            ms = device_ms(lambda: tb4.traverse_bvh4(*tables, *rays), 10)
            out = tb4.traverse_bvh4(*tables, *rays)
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = tt.traverse_bvh4_plain(*tables, *rays, stats=stats)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            require(plain[5] == 0, f"{label} march launch {k}: the plain walk dropped {plain[5]}")
            hit = plain[2] >= 0
            differ = [name for name, a, b in zip(OUTPUTS, out, plain[:5])
                      if not (same_bits(a, b) if name in ("t", "rnode", "tri") else same_bits(a[hit], b[hit]))]
            require(not differ, f"{label} march launch {k}: {differ} differ from the plain walk's")
            b_ms, b_by, visits = traversal_bound(stats, 4, 128, n, n, n_dead=n - live)
            hits = int((out[2] >= 0).sum())
            log(f"[march] {label} launch {k}: {n} lanes, {live} live, {hits} hits: traverse_bvh4 {ms:.4f} ms, "
                f"plain {plain_ms:.1f} ms; bound {b_ms:.4f} ms ({b_by}); equal to the plain walk bit for bit on "
                f"every lane; visits {visits}")
            launches.append(dict(lanes=n, live=live, hits=hits, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by))
        frame = {key: sum(x[key] for x in launches) for key in ("live", "ms", "plain_ms", "bound_ms")}
        frame.update(launches=len(launches), all_launches=len(recorded), rays=float(aux["rays"]))
        log(f"[march] {label} frame: {len(launches)} march launches of {len(recorded)} traverse_bvh4 launches, "
            f"{frame['live']} live lanes: {frame['ms']:.4f} ms (plain {frame['plain_ms']:.1f} ms), bound "
            f"{frame['bound_ms']:.4f} ms, on {smi}")
        results[label] = dict(frame=frame, launches=launches)
        del r, recorded, march
    return results


BRAINSTEM_SIZE, BRAINSTEM_FRAMES = (1024, 1024), 20  # BASELINE config 5 (baseline_standins.cfg row 4)
ANIM_CHECK_FRAMES = 3  # phase 16b's animated frames, card against the CPU
MOVED_NODE, MOVED_BY = 27, (0.0, 0.3, 0.0)  # phase 16c: one terrain instance (of 64) lifted


def _with_variants(path):
    """The helmet stand-in with two KHR_materials_variants (variant 1 maps
    the sphere to a green material), as tests/test_torch_frontends.py writes it."""
    with open(path) as f:
        g = json.load(f)
    g["materials"].append({"name": "green", "pbrMetallicRoughness": {
        "baseColorFactor": [0.1, 0.8, 0.1, 1.0], "roughnessFactor": 0.5, "metallicFactor": 0.0}})
    g["extensions"] = {"KHR_materials_variants": {"variants": [{"name": "base"}, {"name": "green"}]}}
    g["extensionsUsed"] = ["KHR_materials_variants"]
    prim = g["meshes"][0]["primitives"][0]
    prim["extensions"] = {"KHR_materials_variants": {"mappings": [
        {"material": m, "variants": [i]} for i, m in enumerate([prim["material"], len(g["materials"]) - 1])]}}
    out = os.path.join(os.path.dirname(path), "helmet_variants.gltf")
    with open(out, "w") as f:
        json.dump(g, f)
    return out


def _count_world_builds():
    """Wrap renderer.build_world_bvh to count host BVH builds; returns the
    counter dict and a function that restores the original."""
    from vk_gltf_renderer_tpu_torch import renderer as rmod

    calls, orig = {"n": 0}, rmod.build_world_bvh

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    rmod.build_world_bvh = counting
    return calls, lambda: setattr(rmod, "build_world_bvh", orig)


def phase_animation(device, tmp, hdr, smi, terrain):
    """Phase 16: animation and the device refit (module docstring); terrain
    is phase 6's renderer, every table family built."""
    import io
    from contextlib import redirect_stdout

    from vk_gltf_renderer_tpu_torch import headless, scenes
    from vk_gltf_renderer_tpu_torch.models.editor import SceneEditor
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.utils.profiler import format_table, profile_frames, profile_refit

    for key in ("VKGR_PRIMARY_KERNEL", "VKGR_PACKET_KERNEL", "VKGR_TRAVERSAL"):
        os.environ.pop(key, None)
    out = {}
    d = os.path.join(tmp, "brainstem")
    os.makedirs(d, exist_ok=True)
    brainstem = scenes.make_brainstem(d)
    w, h = BRAINSTEM_SIZE

    # (a) BASELINE config 5 through the headless CLI, then the refit timed and profiled apart
    os.environ["VKGR_SETTINGS"] = os.path.join(tmp, "settings_anim.json")
    tb4.COUNTER.launches = 0
    tgather.COUNTER.launches = 0
    builds, restore = _count_world_builds()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        rc = headless.main(["--headless", "--scenefile", brainstem, "--size", str(w), str(h), "--frames",
                            str(BRAINSTEM_FRAMES), "--ptSamples", "1", "--animate", "30",
                            "--output", os.path.join(tmp, "brainstem.png"), "--device", str(device)])
    restore()
    line, rec = _headless_record(buf.getvalue())
    launches = {"traverse_bvh4": tb4.COUNTER.launches, "gather_channels": tgather.COUNTER.launches}
    log(f"[anim] config 5 headless rc {rc} ({time.perf_counter() - t0:.1f} s): {line}")
    log(f"[anim] config 5: {rec['ms_per_frame']:.3f} ms/frame, {rec['Mrays_per_sec']:.3f} Mrays/s on {smi}; "
        f"kernel launches over {BRAINSTEM_FRAMES} frames {launches}; host BVH builds {builds['n']} (the load's)")
    require(rc == 0 and rec["frames"] == BRAINSTEM_FRAMES - 1 and rec["triangles"] == 64
            and rec["Mrays_per_sec"] > 0, f"config 5 record {rec}")
    require(launches["traverse_bvh4"] > 0 and launches["gather_channels"] == 0,
            f"config 5 launches {launches} (the sky: no gather)")
    require(builds["n"] == 1, f"{builds['n']} host BVH builds: animated frames must refit, not rebuild")

    r = GltfRenderer(w, h, spp=SPP, max_depth=DEPTH, device=device)
    r.create_scene(brainstem)
    r.animate = True
    r.on_render()
    refit_ms, frame_ms = [], []
    for _ in range(BRAINSTEM_FRAMES):
        r.step_animation()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        require(r.sync_scene_changes(), "an animation step left nothing to sync")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r.animate = False  # the clip already stepped: on_render syncs a clean scene
        r.on_render()
        r.animate = True
        torch.cuda.synchronize()
        refit_ms.append((t1 - t0) * 1e3)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    prof = profile_frames(r, PROFILED_FRAMES)
    prof_refit = profile_refit(r, PROFILED_FRAMES)
    log(f"[anim] config 5 refit (sync_scene_changes between two synchronizes): {np.mean(refit_ms):.3f} ms a "
        f"frame (min {min(refit_ms):.3f}, max {max(refit_ms):.3f}) of {np.mean(frame_ms):.3f} ms a frame")
    log(format_table(prof, f"[anim] profile config 5 {w}x{h} on {smi}, "))
    log(format_table(prof_refit, f"[anim] profile config 5 refit alone on {smi}, "))
    out["config5"] = dict(headless=rec, launches=launches, refit_ms=float(np.mean(refit_ms)),
                          refit_ms_min=min(refit_ms), refit_ms_max=max(refit_ms),
                          frame_ms=float(np.mean(frame_ms)),
                          profile={k: v for k, v in prof.items() if k != "top"},
                          refit_profile={k: v for k, v in prof_refit.items() if k != "top"})
    del r

    # (b) the card against the port's CPU path: animated brainstem frames, the skinned
    # vertex table, and the helmet after a variant switch through the sync
    res = {}
    for dev in (device, "cpu"):
        rr = GltfRenderer(96, 64, spp=1, max_depth=DEPTH, device=dev)
        rr.create_scene(brainstem)
        rr.animate = True
        frames = []
        for _ in range(ANIM_CHECK_FRAMES):
            aux = rr.on_render()
            frames.append((rr.image_linear(), aux["first_rnode"].cpu().numpy(), aux["first_tri"].cpu().numpy(),
                           float(aux["rays"])))
        res[str(dev)] = (frames, rr.dev_bvh.refit.vtx_pos.cpu(), rr.dev_bvh.refit.vtx_nrm.cpu())
    for i, (card, cpu) in enumerate(zip(res[str(device)][0], res["cpu"][0])):
        _require_agree(f"[anim] brainstem 96x64 animated frame {i}, card vs plain CPU path", card, cpu)
    vtx_err = max(float((res[str(device)][1] - res["cpu"][1]).abs().max()),
                  float((res[str(device)][2] - res["cpu"][2]).abs().max()))
    log(f"[anim] skinned vertex table after {ANIM_CHECK_FRAMES} frames, card vs CPU: max |err| {vtx_err:.3g}")
    require(vtx_err <= 1e-5, f"skinned vertices differ by {vtx_err}")
    var = _with_variants(os.path.join(tmp, "helmet.gltf"))
    res = {}
    for dev in (device, "cpu"):
        rr = GltfRenderer(96, 64, spp=1, max_depth=DEPTH, device=dev)
        rr.create_scene(var)
        rr.create_hdr(hdr)
        builds, restore = _count_world_builds()
        require(rr.set_variant(1) == 1, "the variant switched no primitive")
        restore()
        require(builds["n"] == 0 and rr.dev_bvh.refit is not None, "the variant switch did not refit")
        aux = rr.on_render()
        res[str(dev)] = (rr.image_linear(), aux["first_rnode"].cpu().numpy(), aux["first_tri"].cpu().numpy(),
                         float(aux["rays"]))
    _require_agree("[anim] helmet 96x64 after set_variant(1), card vs plain CPU path", res[str(device)], res["cpu"])
    out["card_vs_cpu_vertex_err"] = vtx_err

    # (c) the refit at a real size: one of the terrain's 64 instances lifted
    r = terrain
    node = r.scene.model.nodes[MOVED_NODE]
    moved_to = [a + b for a, b in zip(node.get("translation", [0.0, 0.0, 0.0]), MOVED_BY)]
    SceneEditor(r.scene).set_translation(MOVED_NODE, moved_to)
    builds, restore = _count_world_builds()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    require(r.sync_scene_changes(), "the node edit left nothing to sync")
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    # the same edit again: the refit's own tables went up with the first one
    SceneEditor(r.scene).set_translation(MOVED_NODE, moved_to)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    require(r.sync_scene_changes(), "the repeated node edit left nothing to sync")
    torch.cuda.synchronize()
    refit2_s = time.perf_counter() - t0
    restore()
    require(builds["n"] == 0, "the node edit rebuilt instead of refitting")
    bvh = r.dev_bvh
    log(f"[anim] terrain ({bvh.num_world_tris} tris, every table family): node {MOVED_NODE} moved by "
        f"{MOVED_BY}, refit (sync_scene_changes) {refit_s * 1e3:.2f} ms "
        f"with the upload of the refit's tables, {refit2_s * 1e3:.2f} ms for the same edit again")

    ro, rd = probe_rays(r, device)
    n = ro.shape[0]
    comps = [ro[:, i].contiguous() for i in range(3)] + [rd[:, i].contiguous() for i in range(3)]
    tmin = torch.zeros(n, device=device)
    far = torch.full((n,), 1e32, device=device)
    g = torch.Generator(device="cpu").manual_seed(99)
    shadow_tmax = (torch.rand(n, generator=g) * float((bvh.scene_hi - bvh.scene_lo).norm())).to(device)
    sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(5))[:PLAIN_CHECK_RAYS].to(device)
    out["refit_kernels"] = _kernel_checks("[anim] refitted terrain", bvh, comps, tmin, far, shadow_tmax, sub)

    # every selection's frame 0 on the refitted tables against the default's
    firsts = {}
    for sel in SELECTIONS + (("packet4", None),):
        for key in ("VKGR_PRIMARY_KERNEL", "VKGR_PACKET_KERNEL", "VKGR_TRAVERSAL"):
            os.environ.pop(key, None)
        if sel[0] == "packet4":
            os.environ["VKGR_TRAVERSAL"] = "packet4"
        else:
            os.environ["VKGR_PRIMARY_KERNEL"], os.environ["VKGR_PACKET_KERNEL"] = sel
        r.frame_idx = 0
        r.reset_frame()
        aux = r.on_render()
        firsts[sel] = (r.image_linear(), aux["first_rnode"].cpu().numpy(), aux["first_tri"].cpu().numpy(),
                       float(aux["rays"]))
    for key in ("VKGR_PRIMARY_KERNEL", "VKGR_PACKET_KERNEL", "VKGR_TRAVERSAL"):
        os.environ.pop(key, None)
    for sel in list(firsts)[1:]:
        _require_agree(f"[anim] refitted terrain frame 0 {sel} vs {SELECTIONS[0]}", firsts[sel], firsts[SELECTIONS[0]])

    # the same edit rebuilt from scratch, and traverse_bvh4 on both trees
    refitted = r.dev_bvh
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.rebuild_device_scene()
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    fresh = r.dev_bvh
    a = tb4.traverse_bvh4(refitted.nodes4_fi, refitted.tris128, refitted.root4_code, *comps, tmin, far)
    b = tb4.traverse_bvh4(fresh.nodes4_fi, fresh.tris128, fresh.root4_code, *comps, tmin, far)
    same = (a[1] == b[1]) & (a[2] == b[2])
    hit = (a[2] >= 0) | (b[2] >= 0)
    tie = (a[0] - b[0]).abs() <= 1e-5 * (1 + b[0].abs())
    ids = float(same.float().mean())
    others = int((~same & ~tie).sum())
    log(f"[anim] terrain refit {refit2_s * 1e3:.2f} ms against rebuild_device_scene {rebuild_s:.2f} s on the same "
        f"edit; traverse_bvh4 on the refitted tree vs a fresh build of the moved scene: ids equal on {ids:.6f} of "
        f"{n} rays ({int(hit.sum())} hit), {int((~same).sum())} differ, of which {others} beyond equal-t ties "
        f"(1e-5)")
    require(ids >= 0.999 and others <= n * 1e-4, "the refitted tree and the fresh build disagree")
    out["terrain"] = dict(world_tris=bvh.num_world_tris, first_refit_ms=refit_s * 1e3, refit_ms=refit2_s * 1e3,
                          rebuild_s=rebuild_s, ids_equal=ids, id_differ=int((~same).sum()),
                          beyond_ties=others, moved_node=MOVED_NODE, moved_by=list(MOVED_BY))
    return out


def _kernel_checks(tag, bvh, comps, tmin, far, shadow_tmax, sub):
    """Every traversal kernel on bvh's tables (every family built) against
    its plain walk on the rays `sub`: closest-hit t bit for bit, the rays
    whose (rnode, tri) ids differ (equal-t ties) counted, any-hit occlusion
    equal, nothing dropped. tag heads the log lines."""
    from vk_gltf_renderer_tpu_torch.ops import traverse as tt

    mods = _traversal_modules()
    runs = _traversal_runs(bvh)
    # the split kernels walk closest hit only; their ids are tris rows
    runs["traverse_bvh4_split"] = (
        lambda *a, anyhit: mods["traverse_bvh4_split"].traverse_bvh4_split(bvh.nodes4_f, bvh.nodes4_i, bvh.tris, *a),
        lambda *a, anyhit: tt.traverse_bvh4_split_plain(bvh.nodes4_f, bvh.nodes4_i, bvh.tris, *a))
    runs["traverse_bvh2_split"] = (
        lambda *a, anyhit: mods["traverse_bvh2_split"].traverse_bvh2_split(
            bvh.nodes_f, bvh.nodes_i, bvh.tris, *a, root_leaf=bvh.bvh2_split_root_leaf),
        lambda *a, anyhit: tt.traverse_bvh2_split_plain(bvh.nodes_f, bvh.nodes_i, bvh.tris, *a))
    names = ("traverse_bvh4", "traverse_bvh4_sidecar", "traverse_bvh2", "traverse_bvh16", "traverse_bvh4_multipop",
             "traverse_bvh4_leafqueue", "traverse_lanes", "traverse_bvh4_split", "traverse_bvh2_split")
    require(set(names) <= set(runs), f"{tag}: tables missing for {sorted(set(names) - set(runs))}")
    out = {}
    for name in names:
        kern, plain = runs[name][0], runs[name][1]
        mods[name].OVERFLOW.reset()
        res = {}
        for anyhit, tmax in ((False, far), (True, shadow_tmax)):
            if anyhit and name in ("traverse_bvh4_split", "traverse_bvh2_split"):
                continue
            args = tuple(x[sub].contiguous() for x in (*comps, tmin, tmax))
            k = kern(*args, anyhit=anyhit)
            p = plain(*args, anyhit=anyhit)
            require(len(p) < 6 or p[5] == 0, f"{tag} {name}: the plain walk dropped {p[5] if len(p) > 5 else 0}")
            if anyhit:
                require(torch.equal(k[2] >= 0, p[2] >= 0), f"{tag} {name}: any-hit occlusion differs")
                res["occluded"] = int((k[2] >= 0).sum())
                continue
            require(same_bits(k[0], p[0]), f"{tag} {name}: closest-hit t differs from the plain walk "
                    f"on {int((k[0].view(torch.int32) != p[0].view(torch.int32)).sum())} rays")
            # with t equal in every bit, rays whose ids differ hit two triangles at one t
            res.update(hits=int((p[2] >= 0).sum()), id_ties=int(((k[1] != p[1]) | (k[2] != p[2])).sum()))
        require(mods[name].OVERFLOW.total() == 0, f"{tag} {name}: dropped work")
        log(f"{tag}, {name} vs its plain walk on {sub.shape[0]} rays: closest-hit t bit for bit "
            f"({res['hits']} hits, {res['id_ties']} equal-t id ties), occlusion equal ({res.get('occluded', '-')})")
        out[name] = res
    return out


FOLIAGE_CARDS = 16384  # scenes.make_foliage_standin at its full size: 32,768 source triangles
CHECK_CARDS = 1024  # phase 5's card-against-CPU foliage: the CPU build and frame of the full size take seconds
FOLIAGE_TIMED = {"subtri": 4, "whole": 4, "none": 4}  # timed 1080p foliage frames by acceleration level
LEVELS = ("subtri", "whole", "none")  # opacity classes per cell, per triangle, none (GltfRenderer._alpha_classes)
REPLAY_WALKED = 8192  # lanes of each replayed alpha launch that the plain walk takes
PLANE_HEIGHT = -1.05  # the helmet stand-in's shadow-catcher plane: between its plate (y -1.1) and its sphere
_CLASSES = {}  # foliage scene path -> (tri_class, subtri_cells, {seconds}): classified once a run


def foliage_scene(tmp, cards=FOLIAGE_CARDS):
    """The foliage stand-in (cards cards, seed 0), written once into tmp/foliage_<cards>."""
    from vk_gltf_renderer_tpu_torch.scenes import make_foliage_standin

    path = os.path.join(tmp, f"foliage_{cards}", "foliage.gltf")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        make_foliage_standin(os.path.dirname(path), cards=cards)
    return path


def foliage_renderer(path, w, h, device, level="subtri"):
    """A GltfRenderer for the foliage stand-in at path whose opacity classes
    (ops/omm.py, on the host) are computed by its first build in this run,
    timed, and handed to every later renderer of the same file: the classes
    depend on the host tables only, and the subtriangle pass takes seconds.
    level "whole" drops the cells, "none" the classes (acceleration off)."""
    from vk_gltf_renderer_tpu_torch.ops.omm import classify_attr_alpha, classify_subtri
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    r = GltfRenderer(w, h, spp=SPP, max_depth=DEPTH, device=device)

    def classes():
        if path not in _CLASSES:
            t0 = time.perf_counter()
            cls = classify_attr_alpha(r.flat)
            t1 = time.perf_counter()
            cells = classify_subtri(r.flat, cls)
            _CLASSES[path] = (cls, cells, {"whole_s": t1 - t0, "subtri_s": time.perf_counter() - t1})
        cls, cells, _ = _CLASSES[path]
        return {"subtri": (cls, cells), "whole": (cls, None), "none": (None, None)}[level]

    r._alpha_classes = classes
    return r


def _launch_kind(rays, anyhit, n_pixels):
    """What a recorded traverse_bvh4 launch of a frame traced: "any" (a
    shadow test), "march" (a shadow march round, closest hit from tmin
    1e-4), "bounce" (a bounce's closest-hit trace, every pixel's lane) or
    "retrace" (an alpha round: the rejecting lanes only, from tmin 0)."""
    if anyhit:
        return "any"
    if bool((rays[6] > 0).all()):
        return "march"
    return "bounce" if rays[0].shape[0] == n_pixels else "retrace"


def phase_alpha(device, tmp, hdr, smi):
    """Phase 17: stochastic alpha and the infinite plane (module docstring)."""
    import io
    from contextlib import redirect_stdout

    from vk_gltf_renderer_tpu_torch import headless
    from vk_gltf_renderer_tpu_torch.models import DirtyFlags
    from vk_gltf_renderer_tpu_torch.ops import omm
    from vk_gltf_renderer_tpu_torch.ops import traverse as tt
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.ops.intersect import STACK_CAPACITY
    from vk_gltf_renderer_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    for key in ("VKGR_PRIMARY_KERNEL", "VKGR_PACKET_KERNEL", "VKGR_TRAVERSAL", "VKGR_OMM_SUBTRI"):
        os.environ.pop(key, None)
    out = {}
    path = foliage_scene(tmp)
    n_pixels = FRAME_W * FRAME_H

    # (a) the build: classes, culled and split rows, world rows, tables and stacks
    t0 = time.perf_counter()
    r = foliage_renderer(path, FRAME_W, FRAME_H, device)
    r.create_scene(path)
    r.create_hdr(hdr)
    build_s = time.perf_counter() - t0
    cls, cells, secs = _CLASSES[path]
    trans = cells == omm.ALPHA_TRANSPARENT
    mixed = cls == omm.ALPHA_MIXED
    split = mixed & trans.any(1) & ~trans.all(1)
    src = int(r.flat.tri_idx.shape[0])
    build = dict(cards=FOLIAGE_CARDS, source_tris=src, classify_whole_s=secs["whole_s"],
                 classify_subtri_s=secs["subtri_s"], build_s=build_s,
                 classes={name: int((cls == c).sum()) for name, c in (("opaque", omm.ALPHA_OPAQUE),
                                                                      ("mixed", omm.ALPHA_MIXED),
                                                                      ("transparent", omm.ALPHA_TRANSPARENT))},
                 culled_rows=int((cls == omm.ALPHA_TRANSPARENT).sum() + (mixed & trans.all(1)).sum()),
                 split_rows=int(split.sum()), virtual_rows=int(r.bvh.attr_rnode.shape[0] - src),
                 world_rows={"subtri": int(r.bvh.num_world_tris)}, tables=_scene_tables(r))
    secs_tables = _all_tables(r, device)
    bvh = r.dev_bvh
    need = {family: (bvh.stack_need[family], STACK_CAPACITY[family]) for family in STACK_CAPACITY}
    build.update(stack_need=need, kernel_tables_s=secs_tables)
    log(f"[alpha] foliage stand-in, {FOLIAGE_CARDS} cards, {src} source triangles: classes {build['classes']} in "
        f"{secs['whole_s']:.2f} s (whole triangles) + {secs['subtri_s']:.2f} s (level-2 cells, host numpy); "
        f"{build['culled_rows']} rows culled, {build['split_rows']} split into {build['virtual_rows']} virtual "
        f"rows; {build['world_rows']['subtri']} world rows; create_scene + create_hdr {build_s:.1f} s; tables "
        f"{build['tables']}; stack need / capacity {need}")
    require(all(a <= b for a, b in need.values()), f"a foliage tree outgrows its kernel's stack: {need}")
    require(build["virtual_rows"] > 0 and build["culled_rows"] > 0, "the foliage build culled or split nothing")
    log(f"[time] alpha build done at {time.perf_counter() - t_phase:.1f} s into the phase")

    # (b) one 1080p frame recorded: the re-trace rounds and the march through traverse_bvh4 and its plain walk
    tables = (bvh.nodes4_fi, bvh.tris128, bvh.root4_code)
    r.frame_idx = 0
    r.reset_frame()
    tb4.OVERFLOW.reset()
    recorded, aux = record_launches(r, "traverse_bvh4")
    kinds = [_launch_kind(rays, anyhit, n_pixels) for rays, anyhit in recorded]
    per_kind = {k: kinds.count(k) for k in ("bounce", "retrace", "march", "any")}
    log(f"[alpha] foliage 1080p frame: {len(recorded)} traverse_bvh4 launches {per_kind}, {float(aux['rays']):.0f} "
        f"rays counted")
    require(per_kind["retrace"] > 0 and per_kind["march"] > 0 and per_kind["any"] == 0,
            f"the alpha frame took no re-trace or no march: {per_kind}")
    # each launch timed on all its lanes; the plain walk takes a fixed subset of every launch of a
    # kind in one call (its cost is the walk's step count, not its lanes), split back per launch
    launches, subsets = [], {"retrace": [], "march": []}
    for k, ((rays, anyhit), kind) in enumerate(zip(recorded, kinds)):
        if kind not in subsets:
            continue
        n = rays[0].shape[0]
        ms = device_ms(lambda: tb4.traverse_bvh4(*tables, *rays), 10)
        m = min(n, REPLAY_WALKED)
        sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(70 + k))[:m].to(device)
        subsets[kind].append((k, tuple(a[sub].contiguous() for a in rays)))
        launches.append(dict(kind=kind, index=k, lanes=n, live=int((rays[7] >= 0).sum()), walked=m, ms=ms))
    replay = {}
    for kind, subs in subsets.items():
        sargs = tuple(torch.cat(parts) for parts in zip(*(a for _, a in subs)))
        kern = tb4.traverse_bvh4(*tables, *sargs)
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = tt.traverse_bvh4_plain(*tables, *sargs, stats=stats)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        require(plain[5] == 0, f"alpha {kind} launches: the plain walk dropped {plain[5]}")
        hit = plain[2] >= 0
        sizes = [a[0].shape[0] for _, a in subs]
        for (k, _), *outs in zip(subs, *(x.split(sizes) for x in (*kern, *plain[:5], hit))):
            ko, po, h = outs[:5], outs[5:10], outs[10]
            differ = [name for name, a, b in zip(OUTPUTS, ko, po)
                      if not (same_bits(a, b) if name in ("t", "rnode", "tri") else same_bits(a[h], b[h]))]
            require(not differ, f"alpha {kind} launch {k}: {differ} differ from the plain walk's")
        mine = [x for x in launches if x["kind"] == kind]
        lanes, live, walked = (sum(x[key] for x in mine) for key in ("lanes", "live", "walked"))
        b_ms, b_by, visits = traversal_bound(stats, 4, 128, lanes, walked, n_dead=lanes - live)
        replay[kind] = dict(launches=len(mine), lanes=lanes, live=live, walked=walked,
                            ms=sum(x["ms"] for x in mine), plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"[alpha] {kind} launches of the frame ({len(mine)}): {lanes} lanes, {live} live; traverse_bvh4 "
            f"{replay[kind]['ms']:.4f} ms on all of them, per launch {[round(x['ms'], 4) for x in mine]}; plain "
            f"walk {plain_ms:.1f} ms on {walked} of them ({int(hit.sum())} hits), t, rnode, tri equal to the "
            f"kernel's bit for bit, u and v on hits; bound {b_ms:.4f} ms ({b_by}); visits {visits}")
    require(tb4.OVERFLOW.total() == 0, "traverse_bvh4 dropped work on the foliage tables")
    log(f"[alpha] foliage frame replay on {smi}: re-trace rounds {replay['retrace']}, march {replay['march']}")
    out["replay"] = dict(frame=replay, launches=[[x["kind"], x["lanes"], x["live"], x["ms"]] for x in launches],
                         launches_fields=["kind", "lanes", "live", "ms"], launches_per_frame=per_kind)
    del recorded
    log(f"[time] alpha re-trace and march replay done at {time.perf_counter() - t_phase:.1f} s into the phase")

    # (c) every traversal kernel against its plain walk on the culled and split tables
    ro, rd = probe_rays(r, device)
    n = ro.shape[0]
    comps = [ro[:, i].contiguous() for i in range(3)] + [rd[:, i].contiguous() for i in range(3)]
    tmin = torch.zeros(n, device=device)
    far = torch.full((n,), 1e32, device=device)
    g = torch.Generator(device="cpu").manual_seed(98)
    shadow_tmax = (torch.rand(n, generator=g) * float((bvh.scene_hi - bvh.scene_lo).norm())).to(device)
    sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(6))[:SUBSET].to(device)
    out["kernels"] = _kernel_checks("[alpha] foliage tables", bvh, comps, tmin, far, shadow_tmax, sub)
    del ro, rd, comps, tmin, far, shadow_tmax
    log(f"[time] alpha kernel checks done at {time.perf_counter() - t_phase:.1f} s into the phase")

    # (d) 1080p frames at each acceleration level, frame indices from 0, images against subtri's
    levels, images = {}, {}
    calls, restore = _count_bvh4_calls()
    try:
        for level in LEVELS:
            if level != "subtri":
                r = foliage_renderer(path, FRAME_W, FRAME_H, device, level)
                r.create_scene(path)
                r.create_hdr(hdr)
            for k in calls:
                calls[k] = 0
            tb4.COUNTER.launches = 0
            r.frame_idx = 0
            r.reset_frame()
            # every level's image is compared after the same frames: subtri's is kept after as many
            n_cmp = FOLIAGE_TIMED["whole"]
            times, rays, _ = _render_frames(r, WARMUP, n_cmp)
            images[level] = r.image_linear()
            more_times, more_rays, _ = _render_frames(r, 0, FOLIAGE_TIMED[level] - n_cmp)
            times, rays = times + more_times, rays + more_rays
            frames = WARMUP + FOLIAGE_TIMED[level]
            require(np.isfinite(images[level]).all() and images[level].mean() > 0.01,
                    f"foliage {level}: image black or not finite")
            require(tb4.COUNTER.launches == calls["closest"] + calls["any"] > 0,
                    f"foliage {level}: traverse_bvh4 launches {tb4.COUNTER.launches} against calls {calls}")
            levels[level] = dict(world_rows=int(r.bvh.num_world_tris), ms=1e3 * float(np.mean(times)),
                                 min_ms=1e3 * min(times), max_ms=1e3 * max(times),
                                 mrays=float(np.mean(rays)) / float(np.mean(times)) / 1e6, rays=float(np.mean(rays)),
                                 traverse_bvh4_per_frame=tb4.COUNTER.launches / frames)
            build["world_rows"][level] = levels[level]["world_rows"]
            log(f"[alpha] foliage {level} {FRAME_W}x{FRAME_H}, {levels[level]['world_rows']} world rows: "
                f"{levels[level]['ms']:.2f} ms/frame (min {levels[level]['min_ms']:.2f}, max "
                f"{levels[level]['max_ms']:.2f}) over {FOLIAGE_TIMED[level]} frames, {levels[level]['rays']:.0f} "
                f"rays/frame, {levels[level]['mrays']:.3f} Mrays/s, traverse_bvh4 "
                f"{levels[level]['traverse_bvh4_per_frame']:.2f} launches a frame, on {smi}")
            if level == "subtri":
                r_subtri = r
    finally:
        restore()
    for level in LEVELS[1:]:
        diff = np.abs(images[level] - images["subtri"]).max(-1)
        rel = np.abs(images[level].mean((0, 1)) - images["subtri"].mean((0, 1))) / images["subtri"].mean((0, 1))
        levels[level]["pixels_within_2e-3"] = float((diff <= 2e-3).mean())
        levels[level]["mean_rel_diff"] = float(rel.max())
        log(f"[alpha] foliage {level} against subtri after {WARMUP + FOLIAGE_TIMED[level]} frames each: pixels "
            f"within 2e-3 "
            f"{levels[level]['pixels_within_2e-3']:.4f}, channel-mean rel diff {levels[level]['mean_rel_diff']:.2e}")
    del r, images
    r = r_subtri
    log(f"[time] alpha level frames done at {time.perf_counter() - t_phase:.1f} s into the phase")

    # (e) MASK -> OPAQUE: the classes move, the sync rebuilds and un-culls
    del r._alpha_classes  # the renderer's own classification from here
    r.scene.model.materials[1]["alphaMode"] = "OPAQUE"
    r.scene.mark_dirty(DirtyFlags.MATERIALS)
    builds, restore = _count_world_builds()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    require(r.sync_scene_changes(), "the material edit left nothing to sync")
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    restore()
    rows = int(r.bvh.num_world_tris)
    r.on_render()
    img = r.image_linear()
    log(f"[alpha] MASK -> OPAQUE on the leaf material: sync_scene_changes rebuilt ({builds['n']} host build) in "
        f"{rebuild_s:.2f} s; world rows {build['world_rows']['subtri']} -> {rows} (source triangles {src})")
    require(builds["n"] == 1 and rows == src and np.isfinite(img).all(),
            f"the MASK -> OPAQUE edit: {builds['n']} builds, {rows} world rows of {src}")
    out["mask_to_opaque"] = dict(rebuild_s=rebuild_s, world_rows=rows)
    del r, r_subtri
    log(f"[time] alpha MASK -> OPAQUE rebuild done at {time.perf_counter() - t_phase:.1f} s into the phase")

    # (f) headless on the helmet stand-in over the shadow-catcher plane at 1080p
    os.environ["VKGR_SETTINGS"] = os.path.join(tmp, "settings_plane.json")
    png = os.path.join(tmp, "plane.png")
    tb4.COUNTER.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        rc = headless.main(["--headless", "--scenefile", os.path.join(tmp, "helmet.gltf"), "--hdrfile", hdr,
                            "--envSystem", "1", "--size", str(FRAME_W), str(FRAME_H), "--frames", "6",
                            "--infinitePlane", "1", "--infinitePlaneDistance", str(PLANE_HEIGHT),
                            "--infinitePlaneShadowCatcher", "1", "--output", png, "--device", str(device)])
    line, rec = _headless_record(buf.getvalue())
    with open(png, "rb") as f:
        pimg = read_png(f.read())
    log(f"[alpha] headless helmet + shadow-catcher plane at y {PLANE_HEIGHT} rc {rc} "
        f"({time.perf_counter() - t0:.1f} s): {line}; PNG {pimg.shape} mean {pimg.mean(axis=(0, 1)).round(2).tolist()}; "
        f"traverse_bvh4 launches {tb4.COUNTER.launches}")
    require(rc == 0 and rec["frames"] == 5 and rec["Mrays_per_sec"] > 0 and tb4.COUNTER.launches > 0,
            f"plane headless record {rec}")
    require(pimg.shape == (FRAME_H, FRAME_W, 3) and pimg.mean() > 1, "plane headless PNG is wrong or black")
    out.update(build=build, levels=levels, plane_headless=rec)
    return out


VIEWER_SIZE = (1024, 1024)  # phase 18a: BASELINE config 5's frame
VIEWER_WARMUP, VIEWER_TIMED = 2, 4  # phase 18a's guided frames
PREVIEW_TIMED = 3  # phase 18d: timed preview frames of each configuration, after 1 warm-up
MOVED_BY_X = (0.3, 0.0, 0.0)  # phase 18b: the helmet's sphere instance moves by this between two frames
PICK_PIXELS = [(x, y) for x in (760, 900, 1020, 1160) for y in (380, 500, 600, 760)]  # phase 18e, 1080p


def _sync_ms(fn):
    """(result, host ms) of fn between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def phase_viewer(device, tmp, hdr, smi):
    """Phase 18: what the viewer shows of a frame on the card: guided
    frames and image_denoised, instance motion, headless --upscale 2 and
    the preview, and picking."""
    import io
    from contextlib import redirect_stdout

    from vk_gltf_renderer_tpu_torch import headless
    from vk_gltf_renderer_tpu_torch import renderer as trenderer
    from vk_gltf_renderer_tpu_torch.models.editor import SceneEditor
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.ops.ibl import build_ibl
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.scenes import make_brainstem
    from vk_gltf_renderer_tpu_torch.utils.png import read_png
    from vk_gltf_renderer_tpu_torch.utils.profiler import format_table, profile_denoise, profile_frames

    t_phase = time.perf_counter()
    out, launches = {}, {}
    helmet = os.path.join(tmp, "helmet.gltf")

    def zero():
        tb4.COUNTER.launches = tgather.COUNTER.launches = 0

    def per_frame(frames):
        return {"traverse_bvh4": tb4.COUNTER.launches / frames, "gather_channels": tgather.COUNTER.launches / frames}

    # (a) BASELINE config 5 with the guides: each frame on_render, then image_denoised
    d = os.path.join(tmp, "brainstem_viewer")
    os.makedirs(d, exist_ok=True)
    w, h = VIEWER_SIZE
    r = GltfRenderer(w, h, spp=SPP, max_depth=DEPTH, device=device)
    r.denoise_guides = r.animate = True
    r.create_scene(make_brainstem(d))
    zero()
    frame_ms, den_ms, rays = [], [], []
    for i in range(VIEWER_WARMUP + VIEWER_TIMED):
        aux, ms = _sync_ms(r.on_render)
        den, dms = _sync_ms(lambda: r.image_denoised())
        miss = ~aux["solid"]
        hd = aux["spec_hitdist"]
        require(all(bool(torch.isfinite(aux[k]).all()) for k in ("albedo", "normal", "roughness", "spec_albedo",
                                                                  "spec_hitdist", "first_pos_prev",
                                                                  "lum_moments")),
                f"guided frame {i}: a guide is not finite")
        require(bool(((hd == 65504.0) | (hd < 1e4)).all()), f"guided frame {i}: spec_hitdist out of range")
        require(bool((aux["spec_albedo"][miss] == 0).all()), f"guided frame {i}: spec_albedo on a miss pixel")
        require(den.shape == (h, w, 3) and np.isfinite(den).all(), f"guided frame {i}: denoised image")
        if i >= VIEWER_WARMUP:
            frame_ms.append(ms)
            den_ms.append(dms)
            rays.append(float(aux["rays"]))
    launches["guided_brainstem"] = per_frame(VIEWER_WARMUP + VIEWER_TIMED)
    require(launches["guided_brainstem"]["traverse_bvh4"] > 0, "guided frames: traverse_bvh4 never launched")
    captured = int((aux["spec_hitdist"] > 0).sum())
    out["guided_brainstem"] = dict(size=f"{w}x{h}", ms=float(np.mean(frame_ms)), min_ms=min(frame_ms),
                                   max_ms=max(frame_ms), denoise_ms=float(np.mean(den_ms)),
                                   denoise_min_ms=min(den_ms), mrays=float(np.mean(rays)) / float(np.mean(frame_ms))
                                   / 1e3, launches_per_frame=launches["guided_brainstem"])
    log(f"[viewer] brainstem {w}x{h} guided, animated, {VIEWER_TIMED} frames: {np.mean(frame_ms):.2f} ms/frame "
        f"(min {min(frame_ms):.2f}, max {max(frame_ms):.2f}), image_denoised {np.mean(den_ms):.2f} ms "
        f"(min {min(den_ms):.2f}) on {smi}; {captured} pixels with a specular hit distance; launches a frame "
        f"{launches['guided_brainstem']}")
    del r

    # (b) instance motion: the helmet's sphere moved between two guided frames
    r = GltfRenderer(480, 270, spp=SPP, max_depth=2, device=device)
    r.denoise_guides = True
    r.create_scene(helmet)
    r.on_render()
    nid = r.scene.render_nodes[0].ref_node_id
    t = list(r.scene.model.nodes[nid].get("translation", [0.0, 0.0, 0.0]))
    SceneEditor(r.scene).set_translation(nid, [a + b for a, b in zip(t, MOVED_BY_X)])
    aux = r.on_render()
    motion = (aux["first_pos"] - aux["first_pos_prev"]).cpu().numpy()
    rn = aux["first_rnode"].cpu().numpy()
    moved, still = rn == 0, (rn >= 0) & (rn != 0)
    err_moved = float(np.abs(motion[moved] - np.asarray(MOVED_BY_X)).max())
    err_still = float(np.abs(motion[still]).max())
    log(f"[viewer] helmet 480x270, sphere moved by {MOVED_BY_X}: first_pos - first_pos_prev on its {moved.sum()} "
        f"pixels within {err_moved:.2e} of the move, on the {still.sum()} other hit pixels within {err_still:.2e} of 0")
    require(moved.sum() > 100 and err_moved <= 1e-3 and err_still <= 1e-3, "instance motion is wrong")
    out["instance_motion"] = dict(moved_px=int(moved.sum()), err_moved=err_moved, err_still=err_still)
    del r

    # (c) headless --upscale 2 at 1920x1080 (rendered at 960x540); the renderer kept at save_image
    kept = []
    save = trenderer.GltfRenderer.save_image
    trenderer.GltfRenderer.save_image = lambda self, path: (kept.append(self), save(self, path))[1]
    png = os.path.join(tmp, "upscale.png")
    zero()
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            rc = headless.main(["--headless", "--scenefile", helmet, "--hdrfile", hdr, "--envSystem", "1",
                                "--size", str(FRAME_W), str(FRAME_H), "--frames", "6", "--upscale", "2",
                                "--output", png, "--device", str(device)])
    finally:
        trenderer.GltfRenderer.save_image = save
    launches["taau_helmet"] = per_frame(6)
    line, rec = _headless_record(buf.getvalue())
    with open(png, "rb") as f:
        pimg = read_png(f.read())
    up = kept[0].image_upscaled()
    log(f"[viewer] headless --upscale 2 rc {rc}: {line}; image_upscaled {up.shape}, PNG {pimg.shape}; launches "
        f"a frame {launches['taau_helmet']}")
    require(rc == 0 and rec["frames"] == 5 and rec["Mrays_per_sec"] > 0 and launches["taau_helmet"]["traverse_bvh4"] > 0
            and launches["taau_helmet"]["gather_channels"] > 0, f"upscale headless record {rec}, launches")
    require(kept[0].width * 2 == FRAME_W and up.shape == (FRAME_H, FRAME_W, 3) and np.isfinite(up).all()
            and pimg.shape == (FRAME_H, FRAME_W, 3) and pimg.mean() > 1, "upscaled image is wrong")
    out["taau_headless"] = dict(rec, launches_per_frame=launches["taau_helmet"])
    del kept

    # image_denoised of a guided 1080p helmet frame under the HDR (3 timed calls after 2 frames)
    r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
    r.denoise_guides = True
    r.create_scene(helmet)
    r.create_hdr(hdr)
    for _ in range(2):
        r.on_render()
    den_ms = [_sync_ms(lambda: r.image_denoised())[1] for _ in range(3)]
    prof = profile_denoise(r, PROFILED_FRAMES)
    out["denoise_helmet_1080p"] = dict(ms=float(np.mean(den_ms)), min_ms=min(den_ms),
                                       profile={k: v for k, v in prof.items() if k != "top"})
    log(f"[viewer] image_denoised of a guided helmet {FRAME_W}x{FRAME_H} frame: {np.mean(den_ms):.2f} ms "
        f"(min {min(den_ms):.2f}) on {smi}")
    log(format_table(prof, f"[viewer] profile image_denoised {FRAME_W}x{FRAME_H} on {smi}, "))
    del r

    # (d) preview frames of the helmet at 1080p: sky, HDR, each with and without the wireframe
    r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device, render_system=1)
    r.create_scene(helmet)
    ibl_ms = {}
    for env in ("sky", "hdr"):
        if env == "hdr":
            r.create_hdr(hdr)
        ibl_ms[env] = min(_sync_ms(lambda: build_ibl(r._env(), r.env_kind))[1] for _ in range(3))
        for wire in (False, True):
            r.wireframe = wire
            label = f"preview_{env}" + ("_wireframe" if wire else "")
            _sync_ms(r.on_render)
            zero()
            times = [_sync_ms(r.on_render)[1] for _ in range(PREVIEW_TIMED)]
            launches[label] = per_frame(PREVIEW_TIMED)
            img = r.image_linear()
            require(img.shape == (FRAME_H, FRAME_W, 3) and np.isfinite(img).all() and img.mean() > 0.01,
                    f"{label}: image not finite or black")
            require(launches[label]["traverse_bvh4"] > 0 and (env == "hdr") == (launches[label]["gather_channels"] > 0),
                    f"{label}: launches {launches[label]}")
            out[label] = dict(ms=float(np.mean(times)), min_ms=min(times), max_ms=max(times),
                              rays=float(r._last_aux["rays"]), launches_per_frame=launches[label])
            log(f"[viewer] {label} {FRAME_W}x{FRAME_H}: {np.mean(times):.2f} ms/frame (min {min(times):.2f}, max "
                f"{max(times):.2f}), {float(r._last_aux['rays']):.0f} rays a frame, launches a frame "
                f"{launches[label]} on {smi}")
            if label == "preview_sky":
                prof = profile_frames(r, PROFILED_FRAMES)
                out[label]["profile"] = {k: v for k, v in prof.items() if k != "top"}
                log(format_table(prof, f"[viewer] profile {label} {FRAME_W}x{FRAME_H} on {smi}, "))
    out["build_ibl_ms"] = ibl_ms
    log(f"[viewer] build_ibl (best of 3): sky {ibl_ms['sky']:.2f} ms, hdr {ibl_ms['hdr']:.2f} ms")

    # (e) picks on the card against the port's CPU pick of the same scene and camera
    cpu = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device="cpu")
    cpu.create_scene(helmet)
    zero()
    picks = [r.pick(x, y) for x, y in PICK_PIXELS]
    pick_launches = tb4.COUNTER.launches
    cpu_picks = [cpu.pick(x, y) for x, y in PICK_PIXELS]
    log(f"[viewer] pick at {len(PICK_PIXELS)} pixels: card {picks}, CPU {cpu_picks}; traverse_bvh4 launches "
        f"{pick_launches}")
    require(picks == cpu_picks and pick_launches == len(PICK_PIXELS) and {0, 1} <= set(picks),
            "card picks differ from the CPU's")
    out["picks"] = picks
    out["launches_per_frame"] = launches
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    log(f"[time] viewer phase {secs:.1f} s")
    return out


EDIT_SIZE = (1920, 1080)  # phase 19a: edit_cli renders
VIEWER_EDIT_SIZE = 1024  # phase 19b: the viewer's square frame
VIEWER_CHECK_SIZE = 96  # phase 19c: card against CPU
ADAPTIVE_FRAMES = 6  # phase 19d


def _viewer_keys(px):
    """Phase 19's key script: orbit, select the plate (node 1), grid, gizmo,
    an edit and its undo (refits), a pick at pixel px, denoised display,
    preview."""
    return f"aw+]Gg:translate 1 0 0.1 0;:undo;:gizmo pick {px};np"


def _pick_pixel(path, hdr, size):
    """The pixel under 0.6 of the gizmo's +X axis after the script's first
    keys, and the handle a CPU viewer picks there after the whole script
    (keys only: no frame is rendered)."""
    from vk_gltf_renderer_tpu_torch.ops.gizmo_draw import _Camera
    from vk_gltf_renderer_tpu_torch.viewer import TerminalViewer

    v = TerminalViewer(path, hdr, size=size, max_depth=2, device="cpu")
    for k in "aw+]Gg":
        v.handle_key(k)
    _, pivot, axes, size_w = v._gizmo_frame()
    cam = v.r.camera
    (tip,), (front,) = _Camera(cam.eye, cam.center, cam.up, cam.yfov, size, size).project(
        pivot[None] + axes[0][None] * size_w * 0.6)
    require(bool(front), "gizmo handle behind the camera")
    px = f"{tip[0]:.2f} {tip[1]:.2f}"
    keys = _viewer_keys(px)
    for k in keys[len("aw+]Gg"):]:
        v.handle_key(k)
    return px, v.gizmo_active


def _viewer_run(argv, device, ibl=None):
    """viewer.main(argv) with every frame_u8 between two synchronizes:
    (stdout, [per frame: ms, traverse_bvh4 and gather_channels launches,
    render_system, (linear image, first-hit rnode, first-hit tri, rays)],
    the preview's IBL products). With ibl, the preview shades with those
    products instead of building its own."""
    import io
    from contextlib import redirect_stdout

    from vk_gltf_renderer_tpu_torch import viewer
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    frames, built = [], {}
    frame_u8, ensure_ibl = viewer.TerminalViewer.frame_u8, GltfRenderer._ensure_ibl

    def timed(self):
        sync = torch.cuda.synchronize if self.r.device.type == "cuda" else (lambda: None)
        sync()
        n4, ng = tb4.COUNTER.launches, tgather.COUNTER.launches
        t0 = time.perf_counter()
        img = frame_u8(self)
        sync()
        ms = 1e3 * (time.perf_counter() - t0)
        aux = self.r._last_aux
        rn = aux["first_rnode"].cpu().numpy()
        # a preview frame carries no first-hit triangle: its render node stands in
        tri = aux["first_tri"].cpu().numpy() if "first_tri" in aux else rn
        frames.append(dict(ms=ms, traverse_bvh4=tb4.COUNTER.launches - n4, gather_channels=tgather.COUNTER.launches - ng,
                           render_system=self.r.render_system,
                           first=(self.r.image_linear(), rn, tri, float(aux["rays"]))))
        built["ibl"] = self.r._ibl
        return img

    viewer.TerminalViewer.frame_u8 = timed
    if ibl is not None:
        GltfRenderer._ensure_ibl = lambda self: {k: v.to(self.device) for k, v in ibl.items()}
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            rc = viewer.main(argv + ["--device", str(device)])
    finally:
        viewer.TerminalViewer.frame_u8, GltfRenderer._ensure_ibl = frame_u8, ensure_ibl
    require(rc == 0, f"viewer.main rc {rc}")
    return buf.getvalue(), frames, built.get("ibl")


def _ibl_against_cpu(tag, card, cpu):
    """The card's IBL products against the CPU's build of the same HDR. The
    BRDF LUT reads no environment: within 1e-4 * (1 + |cpu|) everywhere,
    required, and every product finite. The environment's products are
    printed, not required: each of their lookups picks a texel of the
    reduced map by truncation, and where a float32 direction lands within
    an ulp of a texel edge the card's and the CPU's acos / atan2 / sin / cos
    pick neighbours (the glossy chain's level-0 texel centres lie exactly
    on such edges; ROADMAP C)."""
    close = {k: (np.abs(card[k].cpu().numpy() - cpu[k].numpy()) <= 1e-4 * (1 + np.abs(cpu[k].numpy())))
             for k in ("irr", "spec", "brdf")}
    means = {"irr": abs(float(card["irr"].mean()) - float(cpu["irr"].mean())) / abs(float(cpu["irr"].mean()))}
    means.update({f"spec{i}": abs(float(card["spec"][i].mean()) - float(cpu["spec"][i].mean()))
                  / abs(float(cpu["spec"][i].mean())) for i in range(cpu["spec"].shape[0])})
    log(f"{tag}: IBL card vs CPU, share within 1e-4: irr {close['irr'].mean():.6f}, spec {close['spec'].mean():.6f} "
        f"(level 0 {close['spec'][0].mean():.6f}), brdf {close['brdf'].mean():.6f}; mean rel diff "
        + ", ".join(f"{k} {v:.2e}" for k, v in means.items()))
    require(all(bool(torch.isfinite(card[k]).all()) for k in card) and close["brdf"].all(),
            f"{tag}: the IBL products are not finite or the BRDF LUT disagrees")
    return dict(share_within_1e4={k: float(v.mean()) for k, v in close.items()}, mean_rel_diff=means)


def phase_editor(device, tmp, hdr, smi):
    """Phase 19: the editor and the viewer on the card: edit_cli renders
    with an edit and its undo, the scripted viewer with the overlays, the
    viewer card against CPU, and the adaptive sampler."""
    import io
    from contextlib import redirect_stdout

    from vk_gltf_renderer_tpu_torch import edit_cli
    from vk_gltf_renderer_tpu_torch import renderer as trenderer
    from vk_gltf_renderer_tpu_torch.gizmo import Mode
    from vk_gltf_renderer_tpu_torch.models import Scene
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.ops.gizmo_draw import auto_size, gizmo_overlay
    from vk_gltf_renderer_tpu_torch.ops.grid import grid_overlay
    from vk_gltf_renderer_tpu_torch.ops.hdr import load_hdr_environment
    from vk_gltf_renderer_tpu_torch.ops.ibl import build_ibl
    from vk_gltf_renderer_tpu_torch.renderer import AdaptiveSampler, GltfRenderer, fit_camera
    from vk_gltf_renderer_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    out = {}
    helmet = os.path.join(tmp, "helmet.gltf")

    # (a) edit_cli at 1080p: render, translate + render, undo + render, add cube + render, undo
    w, h = EDIT_SIZE
    pngs = {k: os.path.join(tmp, f"edit_{k}.png") for k in ("before", "moved", "undone", "added")}
    cmds = [f"render {pngs['before']} {w} {h}", "translate 0 0 0.25 0", f"render {pngs['moved']} {w} {h}", "undo",
            f"render {pngs['undone']} {w} {h}", "add cube", f"render {pngs['added']} {w} {h}", "undo"]
    renders = []
    on_render, cmd_render = trenderer.GltfRenderer.on_render, edit_cli.EditShell.cmd_render

    def frame(self):
        torch.cuda.synchronize()
        n4 = tb4.COUNTER.launches
        t0 = time.perf_counter()
        aux = on_render(self)
        torch.cuda.synchronize()
        renders[-1].update(frame_ms=1e3 * (time.perf_counter() - t0), traverse_bvh4=tb4.COUNTER.launches - n4)
        return aux

    def render(self, *a):
        torch.cuda.synchronize()
        renders.append({})
        t0 = time.perf_counter()
        cmd_render(self, *a)
        renders[-1]["ms"] = 1e3 * (time.perf_counter() - t0)

    trenderer.GltfRenderer.on_render, edit_cli.EditShell.cmd_render = frame, render
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            rc = edit_cli.main([helmet, "--device", str(device)] + [a for c in cmds for a in ("-c", c)])
    finally:
        trenderer.GltfRenderer.on_render, edit_cli.EditShell.cmd_render = on_render, cmd_render
    printed = buf.getvalue()
    require(rc == 0 and "error:" not in printed and printed.count("rendered ") == 4, f"edit_cli: {printed}")
    data = {}
    for k, path in pngs.items():
        with open(path, "rb") as f:
            data[k] = f.read()
        require(read_png(data[k]).shape == (h, w, 3), f"edit_cli {k}.png")
    require(data["undone"] == data["before"], "edit_cli: the undone render differs from the first")
    require(data["moved"] != data["before"] and data["added"] != data["before"],
            "edit_cli: an edit left the render unchanged")
    require(len(renders) == 4 and all(r["traverse_bvh4"] > 0 for r in renders),
            f"edit_cli renders without traverse_bvh4: {renders}")
    # one render's launches, recorded on a renderer built as cmd_render builds it
    sc = Scene()
    sc.load(helmet)
    r = GltfRenderer(width=w, height=h, spp=1, max_depth=3, device=device)
    r.scene = sc
    r.camera = fit_camera(sc)
    r.rebuild_device_scene()
    recorded, _ = record_launches(r, "traverse_bvh4")
    del r
    require(len(recorded) == renders[0]["traverse_bvh4"], f"recorded {len(recorded)} launches, counted {renders}")
    out["edit_cli"] = dict(size=f"{w}x{h}", renders=renders, recorded_launches=len(recorded))
    log(f"[editor] edit_cli --device cuda on the helmet at {w}x{h} depth 3: render ms (whole cmd_render / frame) "
        + ", ".join(f"{k} {r['ms']:.1f}/{r['frame_ms']:.2f}" for k, r in zip(pngs, renders))
        + f"; traverse_bvh4 launches a render {[r['traverse_bvh4'] for r in renders]} (recorded: {len(recorded)}); "
        f"undone.png == before.png byte for byte, moved and added differ; on {smi}")

    # (b) the viewer at 1024x1024 under the HDR on the card
    size = VIEWER_EDIT_SIZE
    px, cpu_pick = _pick_pixel(helmet, hdr, size)
    png = os.path.join(tmp, "viewer.png")
    printed, frames, _ = _viewer_run(["--scenefile", helmet, "--hdr", hdr, "--size", str(size), "--keys",
                                      _viewer_keys(px), "--output", png], device)
    with open(png, "rb") as f:
        img = read_png(f.read())
    picks = [ln for ln in printed.splitlines() if ln.startswith("gizmo pick -> ")]
    log(f"[viewer] viewer.main --size {size} on the card: {len(frames)} key-frames, ms "
        f"{[round(fr['ms'], 2) for fr in frames]}; traverse_bvh4 launches {[fr['traverse_bvh4'] for fr in frames]}, "
        f"gather_channels {[fr['gather_channels'] for fr in frames]}; {picks[0] if picks else 'no pick'} "
        f"(CPU viewer: {cpu_pick}); on {smi}")
    require(img.shape == (size, size, 3) and img.mean() > 2, "viewer PNG")
    require(picks == [f"gizmo pick -> {cpu_pick}"] and cpu_pick is not None, f"viewer pick {picks} vs CPU {cpu_pick}")
    require(all(fr["traverse_bvh4"] > 0 and fr["gather_channels"] > 0 for fr in frames),
            "a viewer key-frame did not launch traverse_bvh4 and gather_channels")
    # the overlays alone on a 1024x1024 image on the card, best of 3 after a warm-up
    v_img = torch.rand((size, size, 3), device=device)
    depth = torch.rand(size * size, device=device) * 6.0
    cam = fit_camera(sc)
    pivot, axes = np.asarray(sc.world_matrices[1][:3, 3], np.float64), np.eye(3)
    overlays = {"grid": lambda: grid_overlay(v_img, cam.eye, cam.center, cam.up, cam.yfov, scene_depth=depth)}
    for mode in Mode:
        overlays[f"gizmo_{mode.value}"] = (lambda m: lambda: gizmo_overlay(
            v_img, cam.eye, cam.center, cam.up, cam.yfov, pivot, axes, m,
            size=auto_size(cam.eye, pivot, cam.yfov), active=0))(mode)
    overlay_ms = {}
    for label, fn in overlays.items():
        res = [_sync_ms(fn) for _ in range(4)]
        require(all(bool(torch.isfinite(x).all()) for x, _ in res), f"{label} overlay not finite")
        overlay_ms[label] = min(ms for _, ms in res[1:])
    # the least time: read the image (and the depth) once, write the image once
    img_bytes = size * size * 3 * 4
    overlay_bound_ms = {"grid": 1e3 * (2 * img_bytes + size * size * 4) / HBM_BYTES_PER_S,
                        "gizmo": 1e3 * 2 * img_bytes / HBM_BYTES_PER_S}
    log(f"[viewer] overlays at {size}x{size} on the card (best of 3): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in overlay_ms.items())
        + f"; memory bound grid {overlay_bound_ms['grid']:.4f} ms, gizmo {overlay_bound_ms['gizmo']:.4f} ms")
    out["viewer"] = dict(size=size, frames=[{k: v for k, v in fr.items() if k != "first"} for fr in frames],
                         pick=cpu_pick, overlay_ms=overlay_ms, overlay_bound_ms=overlay_bound_ms)

    # (c) the same script at 96x96, depth 2: card against CPU, every frame. The preview shades
    # with the card's IBL products on both, which are held against the CPU's own build apart
    size = VIEWER_CHECK_SIZE
    px, _ = _pick_pixel(helmet, hdr, size)
    argv = ["--scenefile", helmet, "--hdr", hdr, "--size", str(size), "--maxDepth", "2", "--keys", _viewer_keys(px)]
    card = _viewer_run(argv, device)
    cpu = _viewer_run(argv, "cpu", ibl=card[2])
    require(len(card[1]) == len(cpu[1]) and card[0].count("gizmo pick") == 1, "viewer card/CPU runs differ in frames")
    for i, (g, c) in enumerate(zip(card[1], cpu[1])):
        _require_agree(f"[viewer] {size}x{size} frame {i} (render_system {g['render_system']}), card vs CPU",
                       g["first"], c["first"])
    ibl = _ibl_against_cpu(f"[viewer] {size}x{size} preview", card[2],
                           build_ibl(load_hdr_environment(hdr, "cpu"), "hdr"))
    out["viewer_check"] = dict(size=size, frames=len(card[1]), ibl=ibl)

    # (d) the adaptive sampler on 1080p helmet frames under the HDR
    r = GltfRenderer(FRAME_W, FRAME_H, spp=1, max_depth=DEPTH, device=device)
    r.create_scene(helmet)
    r.create_hdr(hdr)
    r.adaptive = AdaptiveSampler(target_fps=10)
    seq, times = [], []
    for _ in range(ADAPTIVE_FRAMES):
        seq.append(r.spp)
        _, ms = _sync_ms(r.on_render)
        times.append(ms)
    seq.append(r.spp)
    require(set(seq) <= set(AdaptiveSampler.BUCKETS) and np.isfinite(r.image_linear()).all(),
            f"adaptive spp sequence {seq}")
    out["adaptive"] = dict(spp=seq, ms=times)
    log(f"[viewer] AdaptiveSampler(target_fps=10) on the helmet {FRAME_W}x{FRAME_H} depth {DEPTH}: spp {seq}, "
        f"ms/frame {[round(t, 2) for t in times]} on {smi}")
    del r
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    log(f"[time] editor phase {secs:.1f} s")
    return out


TEX_SIZE = 2048  # phase 20a: DamagedHelmet's map size
BLOCK_TEX_SIZE = 256  # phase 20a: the per-block Python decoders' (ETC1S, UASTC, ASTC) image
SMALL_TEX_SIZE = 128  # phase 20b's block formats (decoded by the per-block Python code) and 20c-f's JPEG
MESH_FRAMES = 2  # phase 20d: frames of each render_mesh run, against on_render
MESH_ADAPTIVE_FRAMES = 4  # phase 20d
MULTIHOST_TIMEOUT_S = 120  # phase 20e: each rank's limit
LOSSLESS = ("dds_bgra8", "ktx2_rgba8", "ktx2_zlib")
# phase 20: container -> (file name, writer of a uint8 RGB image)
CONTAINERS = {
    "png": ("base.png", encode_png),
    "jpeg_420": ("base_420.jpg", jpeg.encode_jpeg),
    "jpeg_444": ("base_444.jpg", lambda img: jpeg.encode_jpeg(img, subsampling="4:4:4")),
    "jpeg_progressive": ("base_prog.jpg", lambda img: jpeg.encode_jpeg(img, progressive=True)),
    "dds_bgra8": ("base_bgra8.dds", tscenes.dds_bgra8),
    "dds_bc1": ("base_bc1.dds", tscenes.dds_bc1),
    "ktx2_rgba8": ("base_rgba8.ktx2", tscenes.ktx2_rgba8),
    "ktx2_zlib": ("base_zlib.ktx2", lambda img: tscenes.ktx2_rgba8(img, zlib_level=1)),
    "ktx2_etc1s": ("base_etc1s.ktx2", tscenes.ktx2_etc1s),
    "ktx2_uastc": ("base_uastc.ktx2", lambda img: tscenes.ktx2_astc(tscenes.astc_4x4_blocks(img), img.shape[1],
                                                                   img.shape[0], uastc=True)),
    "ktx2_astc": ("base_astc.ktx2", lambda img: tscenes.ktx2_astc(tscenes.astc_4x4_blocks(img), img.shape[1],
                                                                 img.shape[0])),
}
BLOCK_FORMATS = ("ktx2_etc1s", "ktx2_uastc", "ktx2_astc")


def _decode_texture(data):
    """ops/textures.decode_image of one in-memory image: float32 RGBA."""
    from types import SimpleNamespace

    from vk_gltf_renderer_tpu_torch.ops.textures import decode_image

    model = SimpleNamespace(buffer_views=[{"buffer": 0, "byteOffset": 0, "byteLength": len(data)}],
                            buffers=[data], base_dir=None)
    return decode_image(model, {"bufferView": 0})


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _textures_decoders(smi):
    """Phase 20 (a). Returns (records, the 2048x2048 files by container,
    the 2048x2048 image)."""
    out, files = {}, {}
    images = {TEX_SIZE: tscenes.texture_image(TEX_SIZE, seed=0), BLOCK_TEX_SIZE: tscenes.texture_image(BLOCK_TEX_SIZE,
                                                                                                       seed=0)}
    shared = {}  # the ASTC blocks are UASTC's too: encode them once
    for kind, (name, write) in CONTAINERS.items():
        if kind == "png":
            continue
        n = BLOCK_TEX_SIZE if kind in BLOCK_FORMATS else TEX_SIZE
        img = images[n]
        t0 = time.perf_counter()
        if kind in ("ktx2_uastc", "ktx2_astc"):
            if "astc" not in shared:
                shared["astc"] = tscenes.astc_4x4_blocks(img)
            data = tscenes.ktx2_astc(shared["astc"], n, n, uastc=kind == "ktx2_uastc")
        else:
            data = write(img)
        enc_s = time.perf_counter() - t0
        if n == TEX_SIZE:
            files[kind] = data
        t0 = time.perf_counter()
        dec = _decode_texture(data)
        dec_s = time.perf_counter() - t0
        rgb = np.rint(dec[..., :3] * 255.0)
        require(dec.shape == (n, n, 4) and bool(np.all(dec[..., 3] == 1.0)), f"{kind}: decoded {dec.shape}")
        psnr = _psnr(rgb, img)
        if kind in LOSSLESS:
            require(np.array_equal(rgb, img), f"{kind}: a lossless container lost texels")
        else:
            require(psnr > 30.0, f"{kind}: decoded PSNR {psnr:.2f} dB")
        blocks = (n // 4) ** 2
        rec = dict(size=n, bytes=len(data), encode_s=enc_s, decode_s=dec_s, psnr_db=None if kind in LOSSLESS else psnr,
                   decode_mpix_per_s=n * n / dec_s / 1e6)
        extra = ""
        if kind in BLOCK_FORMATS:
            rec.update(us_per_block=dec_s / blocks * 1e6, est_2048_s=dec_s / blocks * (TEX_SIZE // 4) ** 2)
            extra = (f", {rec['us_per_block']:.1f} us a block -> {rec['est_2048_s']:.1f} s for "
                     f"{TEX_SIZE}x{TEX_SIZE}")
        out[kind] = rec
        log(f"[textures] (a) {kind} {n}x{n}: {len(data)} bytes, encode {enc_s:.3f} s, decode {dec_s:.3f} s on the "
            f"host ({rec['decode_mpix_per_s']:.2f} Mpixel/s{extra}), PSNR {psnr:.2f} dB"
            f"{' (lossless: equal texel for texel)' if kind in LOSSLESS else ''}; card {smi}")
    return out, files, images[TEX_SIZE]


def _textured_scenes(tmp, files, img):
    """Phase 20 (b)'s scenes: container -> glTF of the helmet with phase
    (a)'s TEX_SIZE file as its base colour (a SMALL_TEX_SIZE image for the
    per-block formats), and "small_jpeg", the SMALL_TEX_SIZE JPEG helmet of
    (c) to (f)."""
    d = os.path.join(tmp, "textured")
    os.makedirs(d, exist_ok=True)
    small = tscenes.texture_image(SMALL_TEX_SIZE, seed=1)
    out = {"small_jpeg": tscenes.helmet_with_texture(d, jpeg.encode_jpeg(small), "small.jpg")}
    for kind, (name, write) in CONTAINERS.items():
        data = write(small) if kind in BLOCK_FORMATS else encode_png(img) if kind == "png" else files[kind]
        out[kind] = tscenes.helmet_with_texture(d, data, name)
    return out


def _textured_frames(device, textured, hdr, smi):
    """Phase 20 (b)."""
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.parallel import render_mesh
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    out, firsts = {}, {}
    for kind in CONTAINERS:
        scene = textured[kind]
        n = SMALL_TEX_SIZE if kind in BLOCK_FORMATS else TEX_SIZE
        r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
        t0 = time.perf_counter()
        r.create_scene(scene)
        r.create_hdr(hdr)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        require(torch.equal(r.dev_scene.tex_quads, torch.from_numpy(np.asarray(r.flat.tex_quads)).to(device)),
                f"{kind}: the card's texel pool differs from the host's")
        require(r.dev_scene.tex_desc[0, 1:3].tolist() == [n, n], f"{kind}: the base colour did not decode")
        tb4.COUNTER.launches = 0
        tgather.COUNTER.launches = 0
        times, rays, first = _render_frames(r, 0, 1)  # frame 0, timed
        per_frame = {"traverse_bvh4": tb4.COUNTER.launches, "gather_channels": tgather.COUNTER.launches}
        require(all(v > 0 for v in per_frame.values()), f"{kind}: a kernel never launched {per_frame}")
        firsts[kind] = first
        ms = 1e3 * float(np.mean(times))
        out[kind] = dict(tex_size=n, load_s=load_s, ms=ms, rays=float(np.mean(rays)), launches_per_frame=per_frame)
        check = ""
        if kind in LOSSLESS:
            ref = firsts["png"]
            require(all(np.array_equal(a, b) for a, b in zip(first, ref)),
                    f"{kind}: the 1080p frame differs from the PNG texture's")
            check = "; frame 0 equal to the PNG texture's bit for bit"
        log(f"[textures] (b) {kind} {n}x{n} base colour, helmet {FRAME_W}x{FRAME_H} depth {DEPTH}: load "
            f"{load_s:.2f} s, frame 0 {ms:.2f} ms, launches a frame {per_frame}{check}; on {smi}")
        if kind not in LOSSLESS and kind != "png":
            # the same renderer made a 96x64 one: frame 0 on the card (on_render), then frame 0 on the
            # CPU path (render_mesh over the CPU: the plain versions on copies of the card's tables,
            # which equal the host's) -- a CPU renderer would rebuild the same 2048x2048 pool
            r.width, r.height = 96, 64
            res = []
            for render in (r.on_render, lambda: render_mesh(r, ["cpu"])):
                r.frame_idx = 0
                r.reset_frame()
                aux = render()
                res.append((r.image_linear(), aux["first_rnode"].cpu().numpy(), aux["first_tri"].cpu().numpy(),
                            float(aux["rays"])))
            _require_agree(f"[textures] (b) {kind} 96x64 card vs CPU", *res)
        del r
    return out


def _writer_check(device, tmp, scene, hdr, smi):
    """Phase 20 (c): headless --output x.jpg and x.png on the card."""
    import io
    from contextlib import redirect_stdout

    from vk_gltf_renderer_tpu_torch import headless
    from vk_gltf_renderer_tpu_torch.ops.jpeg import decode_jpeg
    from vk_gltf_renderer_tpu_torch.utils.png import read_png

    os.environ["VKGR_SETTINGS"] = os.path.join(tmp, "settings20.json")
    imgs, secs = {}, {}
    for suffix in (".jpg", ".png"):
        path = os.path.join(tmp, "headless20" + suffix)
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()):
            rc = headless.main(["--headless", "--scenefile", scene, "--hdrfile", hdr, "--envSystem", "1",
                                "--size", str(FRAME_W), str(FRAME_H), "--frames", "2", "--output", path,
                                "--device", str(device)])
        secs[suffix] = time.perf_counter() - t0
        require(rc == 0, f"headless --output {path}: rc {rc}")
        with open(path, "rb") as f:
            data = f.read()
        imgs[suffix] = (decode_jpeg if suffix == ".jpg" else read_png)(data)
        require(imgs[suffix].shape == (FRAME_H, FRAME_W, 3), f"headless {suffix}: {imgs[suffix].shape}")
    psnr = _psnr(imgs[".jpg"], imgs[".png"])
    log(f"[textures] (c) headless --output x.jpg at {FRAME_W}x{FRAME_H} on the card ({secs['.jpg']:.1f} s with the "
        f"scene load): read back by ops/jpeg, PSNR {psnr:.2f} dB against the --output x.png image "
        f"({secs['.png']:.1f} s); on {smi}")
    require(psnr > 30.0, f"headless JPEG PSNR {psnr:.2f} dB")
    return dict(psnr_db=psnr, seconds=secs)


def _mesh_check(device, scene, hdr, smi):
    """Phase 20 (d): render_mesh against on_render at 1080p."""
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.parallel import render_mesh
    from vk_gltf_renderer_tpu_torch.renderer import AdaptiveSampler, GltfRenderer

    def make():
        r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
        r.create_scene(scene)
        r.create_hdr(hdr)
        return r

    out = {}
    ref = make()
    ref_frames = [(ref.on_render(), ref.accum.clone()) for _ in range(MESH_FRAMES)]
    del ref
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] if device.type == "cuda" else [device]
    for label, devices in ((f"{device} x2", [device] * 2), ("every card", cards)):
        r = make()
        times = []
        tb4.COUNTER.launches = 0
        tgather.COUNTER.launches = 0
        for aux_ref, accum_ref in ref_frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux = render_mesh(r, devices)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            require(torch.equal(r.accum, accum_ref), f"render_mesh over {label}: the frame differs from on_render's")
            require(float(aux["rays"]) == float(aux_ref["rays"]), f"render_mesh over {label}: rays differ")
            require(all(torch.equal(aux[k], aux_ref[k]) for k in aux_ref), f"render_mesh over {label}: aux differs")
        per_frame = {"traverse_bvh4": tb4.COUNTER.launches / MESH_FRAMES,
                     "gather_channels": tgather.COUNTER.launches / MESH_FRAMES}
        require(all(v > 0 for v in per_frame.values()), f"render_mesh over {label}: a kernel never launched")
        out[label] = dict(shards=len(devices), ms=times, rays=float(aux["rays"]), launches_per_frame=per_frame)
        log(f"[devices] (d) render_mesh over {label} ({len(devices)} shards of {FRAME_H // len(devices)} rows), "
            f"helmet {FRAME_W}x{FRAME_H} depth {DEPTH}: {MESH_FRAMES} frames equal to on_render's bit for bit, rays "
            f"{float(aux['rays']):.0f} equal; ms/frame {[round(t, 2) for t in times]}, launches a frame {per_frame} "
            f"on {smi}")
        del r
    r = make()
    r.adaptive = AdaptiveSampler(target_fps=10)
    seq, times = [r.spp], []
    for _ in range(MESH_ADAPTIVE_FRAMES):
        _, ms = _sync_ms(lambda: render_mesh(r, [device] * 2))
        times.append(ms)
        seq.append(r.spp)
    require(set(seq) <= set(AdaptiveSampler.BUCKETS) and np.isfinite(r.image_linear()).all(),
            f"render_mesh adaptive spp {seq}")
    out["adaptive"] = dict(spp=seq, ms=times)
    log(f"[devices] (d) render_mesh with AdaptiveSampler(target_fps=10) over {device} x2: spp {seq}, ms/frame "
        f"{[round(t, 2) for t in times]}")
    return out


def _multihost_check(device, scene, hdr, smi):
    """Phase 20 (e): two ranks of parallel.multihost on the card (gloo)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vk_gltf_renderer_tpu_torch.parallel.multihost", "--rank", str(rank), "--world", "2",
         "--port", str(port), "--scene", scene, "--hdr", hdr, "--size", str(FRAME_W), str(FRAME_H),
         "--depth", str(DEPTH), "--backend", "gloo", "--device", str(device)],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=MULTIHOST_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    lines = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        ok = [ln for ln in out.splitlines() if ln.startswith(f"MULTIHOST_OK rank={rank} ")]
        require(p.returncode == 0 and len(ok) == 1, f"multihost rank {rank} failed (rc {p.returncode}):\n{out[-3000:]}")
        lines.append(ok[0])
    spps = [ln.split("spps=")[1] for ln in lines]
    require(spps[0] == spps[1], f"multihost ranks' spp differ: {spps}")
    launches = [int(re.search(r"traverse_bvh4=(\d+)", ln).group(1)) for ln in lines]
    require(device.type != "cuda" or min(launches) > 0, f"a rank's shard launched no traverse_bvh4: {launches}")
    for ln in lines:
        log(f"[devices] (e) {ln}")
    log(f"[devices] (e) two gloo ranks on one card, {FRAME_H // 2} rows each of the helmet {FRAME_W}x{FRAME_H}: "
        f"shards equal to the unsharded frame bit for bit, equal spp {spps[0]}; {secs:.1f} s with both processes' "
        f"start; on {smi}")
    return dict(lines=lines, seconds=secs, traverse_bvh4_per_rank=launches)


def _boundary_check(device, helmet_bvh, terrain_bvh, smi):
    """Phase 20 (f): probes.boundary on the helmet and the terrain."""
    from vk_gltf_renderer_tpu_torch.ops import megakernel as mk
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.probes import boundary

    out = {}
    for label, bvh in (("helmet", helmet_bvh), ("terrain", terrain_bvh)):
        mk.COUNTER.launches = 0
        tb4.COUNTER.launches = 0
        res = boundary.measure(bvh, boundary.N, boundary.ITERS, device)
        res["launches"] = {"render_mega": mk.COUNTER.launches, "traverse_bvh4": tb4.COUNTER.launches}
        require(res["launches"]["render_mega"] > 0 and res["launches"]["traverse_bvh4"] > 0,
                f"boundary probe launches {res['launches']}")
        out[label] = res
        log(boundary.report(label, res) + f"\n[boundary] {label} launches {res['launches']}; on {smi}")
    return out


def phase_textures_devices(device, tmp, hdr, smi, terrain_bvh):
    """Phase 20: textures and devices (the module docstring)."""
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    t_phase = time.perf_counter()
    out = {}
    out["decoders"], files, img = _textures_decoders(smi)
    log(f"[time] textures (a) done at {time.perf_counter() - t_phase:.1f} s into the phase")
    textured = _textured_scenes(tmp, files, img)
    del files, img
    out["frames"] = _textured_frames(device, textured, hdr, smi)
    log(f"[time] textures (b) done at {time.perf_counter() - t_phase:.1f} s into the phase")
    out["writer"] = _writer_check(device, tmp, textured["small_jpeg"], hdr, smi)
    out["mesh"] = _mesh_check(device, textured["small_jpeg"], hdr, smi)
    log(f"[time] devices (c), (d) done at {time.perf_counter() - t_phase:.1f} s into the phase")
    out["multihost"] = _multihost_check(device, textured["small_jpeg"], hdr, smi)
    r = GltfRenderer(8, 8, spp=1, max_depth=1, device=device)
    r.create_scene(textured["small_jpeg"])
    out["boundary"] = _boundary_check(device, r.dev_bvh, terrain_bvh, smi)
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    log(f"[time] textures and devices phase {secs:.1f} s")
    return out


SEED_FRAMES = 6  # phase 21b: seeded and unseeded 1080p helmet frames, then SEED_EDIT_FRAMES after an edit
SEED_EDIT_FRAMES = 2
BATCH_SPP, BATCH_TIMED = 4, 2  # phase 21c: spp 4 frames, 1 warm-up and BATCH_TIMED timed per path
# phase 21a: scenes.make_sliver_soup, whose SBVH duplicates references; its plain walks loop until the
# longest ray ends, which the slivers' overlap sets (3,000 slivers took 24-30 s of walks, 1,000 ~40% of that)
SOUP_TRIS = 1000
SOUP_FRAMES = 3  # phase 21a: 1080p soup frames on the SBVH tables (unseeded and seeded) and on the SAH tables
# phase 21a: probe rays each kernel's plain walk takes on the soup's SBVH tables (a cut of phase 16c's
# SUBSET for the phase's time; every kernel still meets all the probe rays against the SAH tables' hits)
SBVH_CHECK_RAYS = 8_192
WEBP_FIXTURES = ROOT / "tests" / "data" / "webp"
WEBP_TEX = 512  # phase 21d: the side of the lossless WebP / PNG base colour
SEED_CARDS = 64  # phase 21b: the foliage stand-in that must leave seeding off


def _sbvh_renderer(path, w, h, device, hdr=None):
    """A renderer whose scene is built under VKGR_BVH=sbvh (the build alone;
    the variable is cleared after it). Returns (renderer, build seconds)."""
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    r = GltfRenderer(w, h, spp=SPP, max_depth=DEPTH, device=device)
    os.environ["VKGR_BVH"] = "sbvh"
    try:
        t0 = time.perf_counter()
        r.create_scene(path)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        del os.environ["VKGR_BVH"]
    if hdr is not None:
        r.create_hdr(hdr)
    require(r.bvh.builder == "sbvh", f"{path}: the SBVH builder did not run ({r.bvh.builder})")
    return r, secs


def _table_mb(dev):
    """MB of each table family a DeviceBvh holds."""
    fams = {"bvh4": ("nodes4_fi", "tris128"), "bvh2": ("nodes_fi",), "bvh16": ("nodes16_fi",),
            "lane": ("lane_entries",), "bvh4_sidecar": ("nodes4_sc",), "split": ("nodes_i", "nodes_f", "nodes_self",
                                                                                   "nodes4_i", "nodes4_f", "tris"),
            "hit": ("hit_attr", "emit2ref")}
    return {f: round(sum(getattr(dev, k).numel() * getattr(dev, k).element_size() for k in keys
                         if getattr(dev, k) is not None) / 1e6, 3) for f, keys in fams.items()}


def _hits_against(tag, bvh, ref_bvh, comps, tmin, far):
    """Every kernel's closest hits on bvh's tables against ref_bvh's (the same
    scene, another tree): t bit for bit, (rnode, tri) but for equal-t ties."""
    from vk_gltf_renderer_tpu_torch.ops.intersect import intersect_rays_packet, intersect_rays_soa

    ro = torch.stack(comps[:3], -1)
    rd = torch.stack(comps[3:], -1)
    out = {}
    for kernel in ("v3", "v5", "v7", "v8", "v2", "v6", "lane", "packet4", "v1"):
        hits = []
        for b in (bvh, ref_bvh):
            if kernel in ("packet4", "v1"):
                hits.append(intersect_rays_packet(b, ro, rd, tmin, far, wide=kernel == "packet4"))
            else:
                hits.append(intersect_rays_soa(b, *comps, tmin, far, kernel=kernel))
        a, r = hits
        require(same_bits(a["t"], r["t"]), f"{tag} {kernel}: closest-hit t differs from the SAH tables' on "
                f"{int((a['t'].view(torch.int32) != r['t'].view(torch.int32)).sum())} rays")
        out[kernel] = int(((a["rnode"] != r["rnode"]) | (a["tri"] != r["tri"])).sum())
    log(f"{tag}: every kernel's closest hits on {comps[0].shape[0]} probe rays equal the SAH tables' (t bit for "
        f"bit; equal-t id ties {out})")
    return out


def _probe_args(r, device, n_sub, seed=98):
    ro, rd = probe_rays(r, device)
    n = ro.shape[0]
    comps = [ro[:, i].contiguous() for i in range(3)] + [rd[:, i].contiguous() for i in range(3)]
    tmin = torch.zeros(n, device=device)
    far = torch.full((n,), 1e32, device=device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    shadow_tmax = (torch.rand(n, generator=g) * float((r.dev_bvh.scene_hi - r.dev_bvh.scene_lo).norm())).to(device)
    sub = torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(6))[:n_sub].to(device)
    return comps, tmin, far, shadow_tmax, sub


def _cpu_whole_frame(r):
    """Frame r.frame_idx of renderer r on the CPU path, whole (a batched or
    seeded config renders there as on the card; a shard would take the
    scan path), from copies of the card's tables: (image, first-hit rnode,
    first-hit tri, rays)."""
    from vk_gltf_renderer_tpu_torch.ops.pathtrace import render_frame_flat
    from vk_gltf_renderer_tpu_torch.parallel.mesh import _tables_on

    cfg = r._config()
    frame = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in r._frame_inputs(cfg).items()}
    accum, aux = render_frame_flat(*_tables_on(r, torch.device("cpu")), frame, cfg)
    return (accum.reshape(r.height, r.width, 3).numpy(), aux["first_rnode"].numpy(), aux["first_tri"].numpy(),
            float(aux["rays"]))


def _soup_frames(r, soup_sah, device, smi):
    """Phase 21 (a): SOUP_FRAMES 1080p frames of the soup on its SBVH tables
    (renderer r), each from one state unseeded and then seeded (whose state
    carries on), against the SAH tables' frames (soup_sah): the
    accumulations equal but at the tie pixels (first-hit ids that differed
    in any frame). Counts the seeds kept on a row of a triangle that has
    other rows (emit2ref names one of its copies)."""
    from vk_gltf_renderer_tpu_torch.ops import pathtrace as tpt

    wb = r.bvh
    n_rows = np.bincount(wb.wtri_tri[wb.wtri_tri >= 0], minlength=wb.num_world_tris)
    kept = {"seeds": 0, "on_copies": 0}
    seed_hits = tpt._primary_seed_hits

    def counted(bvh, ro, rd, prev_ref):
        res = seed_hits(bvh, ro, rd, prev_ref)
        ref = prev_ref[res[5]].cpu().numpy()
        kept["seeds"] += int(ref.size)
        kept["on_copies"] += int((n_rows[wb.wtri_tri[ref]] > 1).sum())
        return res

    ever = torch.zeros(FRAME_W * FRAME_H, dtype=torch.bool, device=device)
    ms = {"unseeded": [], "seeded": [], "sah": []}
    tpt._primary_seed_hits = counted
    try:
        for i in range(SOUP_FRAMES):
            state = (r.accum.clone(), r.total_samples, r.frame_idx, r._prev_first)
            res = {}
            for label, seed in (("unseeded", "0"), ("seeded", "1")):
                os.environ["VKGR_PRIMARY_SEED"] = seed
                r.accum, r.total_samples, r.frame_idx, r._prev_first = state[0].clone(), *state[1:]
                aux, t = _sync_ms(r.on_render)
                require(r._config().primary_seed == (seed == "1"), f"[sbvh] soup {label}: cfg.primary_seed")
                ms[label].append(t)
                res[label] = (r.accum.reshape(-1, 3).clone(), aux["first_rnode"], aux["first_tri"])
            os.environ["VKGR_PRIMARY_SEED"] = "0"
            aux, t = _sync_ms(soup_sah.on_render)
            ms["sah"].append(t)
            res["sah"] = (soup_sah.accum.reshape(-1, 3), aux["first_rnode"], aux["first_tri"])
            u = res["unseeded"]
            for other in ("seeded", "sah"):
                o = res[other]
                ever |= (u[1] != o[1]) | (u[2] != o[2])
            same = ~ever
            for other in ("seeded", "sah"):
                require(ever.float().mean() <= 1e-3 and torch.equal(u[0][same], res[other][0][same]),
                        f"[sbvh] soup frame {i}: the SBVH unseeded accumulation differs from the {other} one "
                        f"beyond {int(ever.sum())} tie pixels")
    finally:
        tpt._primary_seed_hits = seed_hits
        os.environ.pop("VKGR_PRIMARY_SEED", None)
    require(kept["on_copies"] > 0, f"[sbvh] soup: no seed was kept on a duplicated triangle {kept}")
    mean = {k: float(np.mean(v[1:])) for k, v in ms.items()}  # frame 0 warms up
    log(f"[sbvh] (a) soup {FRAME_W}x{FRAME_H}: {SOUP_FRAMES} SBVH frames unseeded and seeded (each from one "
        f"state) and the SAH tables' frames, accumulations equal but at {int(ever.sum())} tie pixels; seeds kept "
        f"{kept['seeds']}, {kept['on_copies']} of them on a triangle with several rows; ms/frame SBVH "
        f"{mean['unseeded']:.2f} unseeded, {mean['seeded']:.2f} seeded, SAH {mean['sah']:.2f}; on {smi}")
    return dict(tie_pixels=int(ever.sum()), seeds_kept=kept["seeds"], seeds_on_copies=kept["on_copies"],
                ms_per_frame=mean)


def _sbvh_phase(device, tmp, hdr, smi, sah):
    """Phase 21 (a); sah: the helmet's 1080p renderer on the SAH tables."""
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.ops.intersect import STACK_CAPACITY
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    out = {}
    helmet = os.path.join(tmp, "helmet.gltf")
    os.makedirs(os.path.join(tmp, "soup21"), exist_ok=True)
    soup = tscenes.make_sliver_soup(os.path.join(tmp, "soup21"), n=SOUP_TRIS)
    t_phase = time.perf_counter()
    for label, path in (("helmet", helmet), ("soup", soup)):
        r, build_s = _sbvh_renderer(path, FRAME_W, FRAME_H, device, hdr)
        _all_tables(r, device)
        nrefs = int(r.bvh.tris.shape[0] - 8)
        need = {f: (r.dev_bvh.stack_need[f], STACK_CAPACITY[f]) for f in STACK_CAPACITY}
        require(all(a <= b for a, b in need.values()), f"[sbvh] {label}: a stack need exceeds its capacity {need}")
        mb = _table_mb(r.dev_bvh)
        log(f"[sbvh] (a) {label}: SBVH build {build_s:.2f} s, {nrefs} references for {r.bvh.num_world_tris} "
            f"triangles, table MB {mb}, stack need / capacity {need}")
        comps, tmin, far, shadow_tmax, sub = _probe_args(r, device, SBVH_CHECK_RAYS)
        entry = dict(build_s=build_s, refs=nrefs, tris=int(r.bvh.num_world_tris), table_mb=mb,
                     stack_need={f: v[0] for f, v in need.items()})
        log(f"[time] sbvh {label} built, tables up, at {time.perf_counter() - t_phase:.1f} s into the phase")
        if label == "helmet":
            # the helmet's SBVH makes no spatial split (its references are its triangles): its kernels are
            # held to the SAH tables' hits here and to their plain walks on the soup
            _all_tables(sah, device)
            entry["sah_table_mb"] = _table_mb(sah.dev_bvh)
            entry["id_ties_vs_sah"] = _hits_against("[sbvh] (a) helmet SBVH", r.dev_bvh, sah.dev_bvh, comps, tmin,
                                                    far)
            del comps, tmin, far, shadow_tmax, sub
            # the 1080p frames: SBVH against SAH, equal but at tie pixels; replayed kernel ms
            frames = {}
            for name, rr in (("sbvh", r), ("sah", sah)):
                tb4.COUNTER.launches = 0
                tgather.COUNTER.launches = 0
                rr.frame_idx = 0
                rr.reset_frame()
                times, rays, first = _render_frames(rr, 1, 2)  # frame 0 is the warm-up
                per_frame = {"traverse_bvh4": tb4.COUNTER.launches / 3, "gather_channels": tgather.COUNTER.launches / 3}
                recorded, _ = record_launches(rr, "traverse_bvh4")
                b = rr.dev_bvh
                k_ms = sum(device_ms(lambda c=c, a=a: tb4.traverse_bvh4(b.nodes4_fi, b.tris128, b.root4_code, *c,
                                                                        anyhit=a), 3) for c, a in recorded)
                frames[name] = dict(ms=1e3 * float(np.mean(times)), replay_kernel_ms=k_ms, first=first,
                                    launches_per_frame=per_frame)
            a, b = frames["sbvh"]["first"], frames["sah"]["first"]
            same = ((a[1] == b[1]) & (a[2] == b[2])).reshape(a[0].shape[:2])
            ties = int((~same).sum())
            require(same.mean() >= 0.999 and np.array_equal(a[0][same], b[0][same]),
                    f"[sbvh] 1080p helmet frame differs from the SAH frame beyond {ties} tie pixels")
            log(f"[sbvh] (a) helmet {FRAME_W}x{FRAME_H}: SBVH frame equal to the SAH frame but at {ties} tie "
                f"pixels; ms/frame SBVH {frames['sbvh']['ms']:.2f}, SAH {frames['sah']['ms']:.2f}; replayed "
                f"traverse_bvh4 kernel ms a frame SBVH {frames['sbvh']['replay_kernel_ms']:.3f}, SAH "
                f"{frames['sah']['replay_kernel_ms']:.3f}; on {smi}")
            entry["frames"] = {k: {kk: vv for kk, vv in v.items() if kk != "first"} for k, v in frames.items()}
            entry["tie_pixels"] = ties
            out["launches_per_frame"] = frames["sbvh"]["launches_per_frame"]
        else:
            # every kernel on the soup's duplicated references: against its plain walk on SBVH_CHECK_RAYS rays,
            # and against the SAH tables' hits on all the probe rays
            entry["kernels"] = _kernel_checks(f"[sbvh] (a) {label} SBVH tables", r.dev_bvh, comps, tmin, far,
                                              shadow_tmax, sub)
            log(f"[time] sbvh soup kernel checks done at {time.perf_counter() - t_phase:.1f} s into the phase")
            soup_sah = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
            soup_sah.create_scene(path)
            soup_sah.create_hdr(hdr)
            _all_tables(soup_sah, device)
            entry["id_ties_vs_sah"] = _hits_against("[sbvh] (a) soup SBVH", r.dev_bvh, soup_sah.dev_bvh, comps, tmin,
                                                    far)
            del comps, tmin, far, shadow_tmax
            # the 1080p frames, unseeded and seeded, against the SAH tables' frames
            entry["frames"] = _soup_frames(r, soup_sah, device, smi)
            del soup_sah
            log(f"[time] sbvh soup frames done at {time.perf_counter() - t_phase:.1f} s into the phase")
            # one node moved: the device refit of the SBVH tables against the CPU's
            cpu, _ = _sbvh_renderer(path, 64, 48, "cpu")
            from vk_gltf_renderer_tpu_torch.models.editor import SceneEditor
            from vk_gltf_renderer_tpu_torch.ops.pathtrace import trace_closest

            for rr in (r, cpu):
                SceneEditor(rr.scene).set_translation(0, [0.4, -0.2, 0.3])
            refit, refit_ms = _sync_ms(r.sync_scene_changes)
            require(refit and cpu.sync_scene_changes() and r.bvh.builder == "sbvh" and r.dev_bvh.refit is not None,
                    "[sbvh] the node edit did not refit the SBVH tables")
            ro, rd = probe_rays(r, device)
            ro, rd = ro[sub], rd[sub]
            hg = trace_closest(r.dev_bvh, ro, rd, kernel="v3")
            hc = trace_closest(cpu.dev_bvh, ro.cpu(), rd.cpu(), kernel="v3")
            require(same_bits(hg["t"].cpu(), hc["t"]) and torch.equal(hg["tri"].cpu(), hc["tri"])
                    and torch.equal(hg["rnode"].cpu(), hc["rnode"]),
                    "[sbvh] the card's SBVH refit gives other hits than the CPU's")
            log(f"[sbvh] (a) soup: node 0 moved, device refit {refit_ms:.2f} ms; traverse_bvh4 on the "
                f"refitted SBVH tables equals the CPU refit's plain walk on {sub.shape[0]} rays (t, rnode, tri bit "
                f"for bit; {int((hc['tri'] >= 0).sum())} hits)")
            entry["refit_ms"] = refit_ms
        log(f"[time] sbvh {label} done at {time.perf_counter() - t_phase:.1f} s into the phase")
        out[label] = entry
        del r
    return out


def _seed_phase(device, tmp, hdr, smi, r):
    """Phase 21 (b); r: the helmet's 1080p renderer on the SAH tables (21a's)."""
    from vk_gltf_renderer_tpu_torch.models.editor import SceneEditor
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import pathtrace as tpt
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    # lockstep on one renderer: each frame from the same state unseeded, then seeded (whose state
    # carries on), so a difference is the seeding's and not another renderer's build or refit
    ms = {"unseeded": [], "seeded": []}
    ties = np.zeros(FRAME_W * FRAME_H, bool)
    tb4.COUNTER.launches = 0
    tgather.COUNTER.launches = 0
    try:
        for i in range(SEED_FRAMES + SEED_EDIT_FRAMES):
            if i == SEED_FRAMES:  # a node edit: the device refit moves the triangles under the seeds
                SceneEditor(r.scene).set_translation(0, [0.05, 0.02, 0.0])
                require(r.sync_scene_changes() and r.dev_bvh.tris is not None, "[seed] the edit did not refit")
            state = (r.accum.clone(), r.total_samples, r.frame_idx, r._prev_first)
            res = {}
            for label, seed in (("unseeded", "0"), ("seeded", "1")):
                os.environ["VKGR_PRIMARY_SEED"] = seed
                r.accum, r.total_samples, r.frame_idx, r._prev_first = state[0].clone(), *state[1:]
                aux, t = _sync_ms(r.on_render)
                require(r._config().primary_seed == (seed == "1"), f"[seed] {label}: cfg.primary_seed")
                ms[label].append(t)
                res[label] = (r.accum.clone(), aux["first_rnode"].cpu().numpy(), aux["first_tri"].cpu().numpy())
            (acc_u, rn_u, tri_u), (acc_s, rn_s, tri_s) = res["unseeded"], res["seeded"]
            tie = (rn_u != rn_s) | (tri_u != tri_s)
            ties |= tie
            same = torch.from_numpy(~tie).to(device)
            require(tie.mean() <= 1e-3 and torch.equal(acc_u[same], acc_s[same]),
                    f"[seed] frame {i}: the seeded accumulation differs from the unseeded one beyond "
                    f"{int(tie.sum())} tie pixels")
            if i == SEED_FRAMES - 1:
                ties_before = int(ties.sum())
        per_frame = {k: c.launches / (2 * (SEED_FRAMES + SEED_EDIT_FRAMES))
                     for k, c in (("traverse_bvh4", tb4.COUNTER), ("gather_channels", tgather.COUNTER))}
        # the primary launch of one more frame, unseeded and seeded: timed with CUDA events
        primary_ms, valid = {}, None
        b = r.dev_bvh
        for label, seed in (("unseeded", "0"), ("seeded", "1")):
            os.environ["VKGR_PRIMARY_SEED"] = seed
            frame = r._frame_inputs(r._config())
            recorded, _ = record_launches(r, "traverse_bvh4")
            c, anyhit = recorded[0]
            primary_ms[label] = device_ms(lambda c=c, a=anyhit: tb4.traverse_bvh4(b.nodes4_fi, b.tris128,
                                                                                  b.root4_code, *c, anyhit=a), 5)
            if seed == "1":  # that frame's seeds, re-verified as render_frame_flat does
                row = (b.rn_attr_base[frame["prev_first_rnode"].long().clamp(min=0)].long()
                       + frame["prev_first_tri"].long().clamp(min=0))
                ref = torch.where(frame["prev_first_tri"] >= 0, b.emit2ref[row.clamp(0, b.emit2ref.shape[0] - 1)], -1)
                valid = float(tpt._primary_seed_hits(b, torch.stack(c[0:3], -1), torch.stack(c[3:6], -1),
                                                     ref)[5].float().mean())
    finally:
        os.environ.pop("VKGR_PRIMARY_SEED", None)
    # the foliage stand-in (alpha): the renderer leaves seeding off
    os.environ["VKGR_PRIMARY_SEED"] = "1"
    try:
        fol = GltfRenderer(64, 48, spp=1, max_depth=2, device=device)
        fol.create_scene(foliage_scene(tmp, SEED_CARDS))
        require(not fol._config().primary_seed, "[seed] the foliage stand-in (alpha) is seeded")
    finally:
        del os.environ["VKGR_PRIMARY_SEED"]
    mean = {k: float(np.mean(v[1:])) for k, v in ms.items()}  # frame 0 warms up
    log(f"[seed] (b) helmet {FRAME_W}x{FRAME_H}: {SEED_FRAMES} seeded frames, each from the unseeded frame's "
        f"state, equal to the unseeded ones but at {ties_before} tie pixels, and after a node edit (a refit) "
        f"{SEED_EDIT_FRAMES} more ({int(ties.sum())} in all); seed valid share {valid:.4f}; primary launch "
        f"{primary_ms['seeded']:.3f} ms seeded, {primary_ms['unseeded']:.3f} ms unseeded (CUDA events); ms/frame "
        f"{mean['seeded']:.2f} seeded, {mean['unseeded']:.2f} unseeded; launches a frame {per_frame}; the foliage "
        f"stand-in ({SEED_CARDS} cards, alpha) left unseeded; on {smi}")
    return dict(tie_pixels=int(ties.sum()), tie_pixels_before_edit=ties_before, seed_valid_share=valid,
                primary_ms=primary_ms, ms_per_frame=mean, launches_per_frame=per_frame)


def _batch_phase(device, tmp, hdr, smi):
    """Phase 21 (c)."""
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.utils.profiler import device_memory_stats

    helmet = os.path.join(tmp, "helmet.gltf")
    out = {}
    for label, batch in (("scan", "0"), ("batched", "1")):
        os.environ["VKGR_SPP_BATCH"] = batch
        try:
            r = GltfRenderer(FRAME_W, FRAME_H, spp=BATCH_SPP, max_depth=DEPTH, device=device)
            r.create_scene(helmet)
            r.create_hdr(hdr)
            require(r._config().spp_batch == (batch == "1"), f"[batch] {label}: cfg.spp_batch")
            r.on_render()  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            tb4.COUNTER.launches = 0
            tgather.COUNTER.launches = 0
            times = [_sync_ms(r.on_render)[1] for _ in range(BATCH_TIMED)]
            peak = device_memory_stats(device)["peak_bytes_in_use"]
            per_frame = {"traverse_bvh4": tb4.COUNTER.launches / BATCH_TIMED,
                         "gather_channels": tgather.COUNTER.launches / BATCH_TIMED}
            img = r.image_linear()
            require(np.isfinite(img).all() and img.mean() > 0.01, f"[batch] {label}: image")
            out[label] = dict(ms=float(np.mean(times)), launches_per_frame=per_frame, peak_bytes=int(peak),
                              rays=float(r._last_aux["rays"]))
            if batch == "1":  # 96x64 on the card against the whole-frame CPU path
                r.width, r.height = 96, 64
                r.frame_idx = 0
                r.reset_frame()
                cpu = _cpu_whole_frame(r)
                aux = r.on_render()
                card = (r.image_linear(), aux["first_rnode"].cpu().numpy(), aux["first_tri"].cpu().numpy(),
                        float(aux["rays"]))
                _require_agree("[batch] (c) batched spp 4 96x64 card vs CPU", card, cpu)
            del r
        finally:
            del os.environ["VKGR_SPP_BATCH"]
    b, s = out["batched"], out["scan"]
    require(b["launches_per_frame"]["traverse_bvh4"] < s["launches_per_frame"]["traverse_bvh4"],
            "[batch] the batched frame launches traverse_bvh4 as often as the scan")
    out["launches_per_frame"] = b["launches_per_frame"]
    log(f"[batch] (c) helmet {FRAME_W}x{FRAME_H} spp {BATCH_SPP}: batched {b['ms']:.2f} ms/frame, scan "
        f"{s['ms']:.2f}; launches a frame (traverse_bvh4, gather_channels) batched "
        f"{b['launches_per_frame']}, scan {s['launches_per_frame']}; peak device bytes batched "
        f"{b['peak_bytes']}, scan {s['peak_bytes']}; rays a frame {b['rays']:.0f} / {s['rays']:.0f}; on {smi}")
    return out


def _webp_phase(device, tmp, hdr, smi):
    """Phase 21 (d)."""
    import hashlib
    import io
    from contextlib import redirect_stdout

    from vk_gltf_renderer_tpu_torch import headless
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.ops import webp
    from vk_gltf_renderer_tpu_torch.parallel import render_mesh
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.utils.image_io import read_image

    meta = json.loads((WEBP_FIXTURES / "digests.json").read_text())["files"]
    decodes = {}
    for name, m in sorted(meta.items()):
        data = (WEBP_FIXTURES / name).read_bytes()
        webp.decode_webp(data)  # the first call builds the coder
        t0 = time.perf_counter()
        rgba = webp.decode_webp(data)
        secs = time.perf_counter() - t0
        require(list(rgba.shape) == m["shape"] and hashlib.sha256(rgba.tobytes()).hexdigest() == m["sha256"],
                f"[webp] {name}: the decode differs from Pillow's digest")
        h, w = rgba.shape[:2]
        lossless = data[12:16] == b"VP8L"
        rate = (f"{1e9 * secs / (w * h):.2f} ns a pixel" if lossless
                else f"{1e6 * secs / (((w + 15) // 16) * ((h + 15) // 16)):.2f} us a macroblock")
        decodes[name] = dict(bytes=len(data), w=w, h=h, host_s=secs, lossless=lossless)
        log(f"[webp] (d) {name} {w}x{h}, {len(data)} bytes: equal to Pillow's decode (sha256); host decode "
            f"{1e3 * secs:.2f} ms, {rate}; 2048x2048 at that rate {secs * 2048 * 2048 / (w * h):.3f} s")
    # the helmet with a WebP base colour: lossless equal to PNG bit for bit, lossy card against CPU
    img = tscenes.texture_image(WEBP_TEX, seed=3)
    d = os.path.join(tmp, "webp21")
    os.makedirs(d, exist_ok=True)
    firsts, launches = {}, {}
    for kind, data, name in (("png", encode_png(img), "base.png"), ("webp_lossless", webp.encode_webp(img),
                                                                     "base.webp"),
                             ("webp_lossy", (WEBP_FIXTURES / "lossy_q80_512.webp").read_bytes(), "lossy.webp")):
        scene = tscenes.helmet_with_texture(d, data, name)
        r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
        r.create_scene(scene)
        r.create_hdr(hdr)
        require(r.dev_scene.tex_desc[0, 1:3].tolist() == [512, 512], f"[webp] {kind}: the base colour did not decode")
        tb4.COUNTER.launches = 0
        tgather.COUNTER.launches = 0
        times, _, first = _render_frames(r, 0, 1)
        firsts[kind] = first
        launches[kind] = {"traverse_bvh4": tb4.COUNTER.launches, "gather_channels": tgather.COUNTER.launches}
        if kind == "webp_lossless":
            require(all(np.array_equal(a, b) for a, b in zip(first, firsts["png"])),
                    "[webp] the lossless WebP frame differs from the PNG frame")
        if kind == "webp_lossy":
            r.width, r.height = 96, 64
            res = []
            for render in (r.on_render, lambda: render_mesh(r, ["cpu"])):
                r.frame_idx = 0
                r.reset_frame()
                aux = render()
                res.append((r.image_linear(), aux["first_rnode"].cpu().numpy(), aux["first_tri"].cpu().numpy(),
                            float(aux["rays"])))
            _require_agree("[webp] (d) lossy WebP base colour 96x64 card vs CPU", *res)
        log(f"[webp] (d) helmet {FRAME_W}x{FRAME_H} with a {kind} base colour: frame 0 {1e3 * times[0]:.2f} ms"
            + ("; equal to the PNG frame bit for bit" if kind == "webp_lossless" else ""))
        del r
    # headless --output x.webp against x.png
    os.environ["VKGR_SETTINGS"] = os.path.join(tmp, "settings21.json")
    outs = {}
    for suffix in (".png", ".webp"):
        path = os.path.join(tmp, "headless21" + suffix)
        with redirect_stdout(io.StringIO()):
            rc = headless.main(["--headless", "--scenefile", os.path.join(tmp, "helmet.gltf"), "--hdrfile", hdr,
                                "--envSystem", "1", "--size", str(FRAME_W), str(FRAME_H), "--frames", "1",
                                "--output", path, "--device", str(device)])
        require(rc == 0, f"headless --output {path}: rc {rc}")
        with open(path, "rb") as f:
            outs[suffix] = f.read()
    png = read_image(outs[".png"])
    got = read_image(outs[".webp"])
    require(got.shape == (FRAME_H, FRAME_W, 4) and np.array_equal(got[..., :3], png[..., :3])
            and (got[..., 3] == 255).all(), "[webp] headless --output x.webp differs from the PNG output")
    log(f"[webp] (d) headless --output x.webp at {FRAME_W}x{FRAME_H} on the card: {len(outs['.webp'])} bytes "
        f"(lossless; the PNG {len(outs['.png'])}), read back equal to the PNG output pixel for pixel; on {smi}")
    return dict(decodes=decodes, headless_webp_bytes=len(outs[".webp"]), headless_png_bytes=len(outs[".png"]),
                launches_per_frame=launches["webp_lossy"], frame_launches=launches)


def phase_sbvh_seed_batch_webp(device, tmp, hdr, smi):
    """Phase 21: the SBVH, seeding, batching and WebP (the module docstring)."""
    t_phase = time.perf_counter()
    for key in ("VKGR_PRIMARY_KERNEL", "VKGR_PACKET_KERNEL", "VKGR_TRAVERSAL", "VKGR_BVH", "VKGR_PRIMARY_SEED",
                "VKGR_SPP_BATCH"):
        os.environ.pop(key, None)
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer

    # the helmet's 1080p renderer on the SAH tables, shared by (a) and (b)
    helmet = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
    helmet.create_scene(os.path.join(tmp, "helmet.gltf"))
    helmet.create_hdr(hdr)
    out = {}
    launches = {}
    for key, fn in (("sbvh", lambda *a: _sbvh_phase(*a, helmet)), ("seed", lambda *a: _seed_phase(*a, helmet)),
                    ("batch", _batch_phase), ("webp", _webp_phase)):
        out[key] = fn(device, tmp, hdr, smi)
        # the main-path frames' launches a frame (counters zeroed before the frames, read after)
        launches[key] = out[key].pop("launches_per_frame")
        require(all(v > 0 for v in launches[key].values()), f"phase 21 ({key}): a kernel never launched {launches}")
        log(f"[time] phase 21 {key} done at {time.perf_counter() - t_phase:.1f} s into the phase")
    del helmet
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[time] SBVH, seeding, batching and WebP phase {out['seconds']:.1f} s")
    return out


IMAGE_FIXTURES = ROOT / "tests" / "data" / "images"
MAP_SIDE = 2048  # phase 22a: the side of each format's timed map
ICON_SIDE = 256  # phase 22a, 22b: an icon's largest size, so ICO and CUR are timed and rendered at 256^2
ICNS_SIDE = 128  # phase 22a, 22b: the largest ICNS icon of RLE channels (it32)
PCD_SIZE = (512, 768)  # phase 22a, 22b: a PhotoCD base image, rows and columns
HALF_MAPS = ("png_sub", "png_average", "png_paeth")  # phase 22a: maps at half the side (a decoder another map times)
FORMATS_TEX = 512  # phase 22b: the side of the base colour


def _tiff_strips(w, h, bps, photometric, strips, rows, compression, extra=()):
    """A little-endian TIFF of the given compressed strips (phase 22a), with
    `extra` (tag, type, values) entries: the IFD at offset 8, the
    out-of-line tag values after it, then the strips."""
    import struct

    offsets = [0] * len(strips)
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, list(bps)), (259, 3, [compression]), (262, 3, [photometric]),
            (273, 4, offsets), (277, 3, [len(bps)]), (278, 4, [rows]), (279, 4, [len(s) for s in strips])]
    tags = sorted(tags + list(extra))

    def pack(typ, v):
        return struct.pack(f"<{len(v)}{'H' if typ == 3 else 'I'}", *v)

    at = 8 + 2 + 12 * len(tags) + 4
    data_at = at + sum(len(pack(typ, v)) for _, typ, v in tags if len(pack(typ, v)) > 4)
    for i, st in enumerate(strips):
        offsets[i] = data_at
        data_at += len(st)
    entries, tail = b"", b""
    for t, typ, v in tags:
        b = pack(typ, v)
        if len(b) > 4:
            entries += struct.pack("<HHII", t, typ, len(v), at + len(tail))
            tail += b
        else:
            entries += struct.pack("<HHI", t, typ, len(v)) + b.ljust(4, b"\0")
    return b"II*\0" + struct.pack("<IH", 8, len(tags)) + entries + b"\0\0\0\0" + tail + b"".join(strips)


def _literal_lzw(data: np.ndarray) -> bytes:
    """TIFF LZW of bytes as 9-bit literal codes only, a clear code every
    253 literals (the table never widens): the decoder's slowest input per
    byte."""
    n = len(data)
    groups = -(-n // 253)
    codes = np.full(groups * 254 + 1, 256, np.int64)
    body = codes[:-1].reshape(groups, 254)
    lit = np.full(groups * 253, -1, np.int64)
    lit[:n] = data
    body[:, 1:] = lit.reshape(groups, 253)
    codes = codes[codes >= 0]
    codes[-1] = 257
    bits = ((codes[:, None] >> np.arange(8, -1, -1)) & 1).astype(np.uint8).reshape(-1)
    return np.packbits(bits).tobytes()


def _literal_packbits(data: np.ndarray) -> bytes:
    """PackBits of bytes as literal packets of 128 (and one short one)."""
    n = len(data)
    full = n // 128
    out = np.empty((full, 129), np.uint8)
    out[:, 0] = 127
    out[:, 1:] = data[: full * 128].reshape(full, 128)
    rest = data[full * 128:]
    return out.tobytes() + (bytes([len(rest) - 1]) + rest.tobytes() if len(rest) else b"")


def _packbits_rows(planes: np.ndarray) -> bytes:
    """PSD PackBits of [c, n, n] planes (n a multiple of 128): each row as
    literal packets of 128, the row byte counts first."""
    c, n, _ = planes.shape
    pk = np.empty((c * n, n // 128, 129), np.uint8)
    pk[..., 0] = 127
    pk[..., 1:] = planes.reshape(c * n, n // 128, 128)
    return np.full(c * n, n // 128 * 129, ">u2").tobytes() + pk.tobytes()


def _psd(img, packbits=True):
    import struct

    n = img.shape[0]
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, 3, n, n, 8, 3) + struct.pack(">III", 0, 0, 0)
    planes = np.ascontiguousarray(img.transpose(2, 0, 1))
    return head + (b"\0\1" + _packbits_rows(planes) if packbits else b"\0\0" + planes.tobytes())


def _sgi(img, rle=True):
    """SGI RGB, rows bottom-up; RLE rows as copy packets of up to 127."""
    import struct

    n = img.shape[0]
    head = struct.pack(">hBBHHHHll4s80sl404s", 474, int(rle), 1, 3, n, n, 3, 0, 255, b"", b"map", 0, b"")
    planes = np.ascontiguousarray(img[::-1].transpose(2, 0, 1)).reshape(3 * n, n)
    if not rle:
        return head + planes.tobytes()
    full, rest = n // 127, n % 127
    row = np.empty((3 * n, full * 128 + (rest + 1 if rest else 0) + 1), np.uint8)
    body = row[:, : full * 128].reshape(3 * n, full, 128)
    body[..., 0] = 0x80 | 127
    body[..., 1:] = planes[:, : full * 127].reshape(3 * n, full, 127)
    if rest:
        row[:, full * 128] = 0x80 | rest
        row[:, full * 128 + 1: full * 128 + 1 + rest] = planes[:, full * 127:]
    row[:, -1] = 0
    length = row.shape[1]
    starts = 512 + 8 * 3 * n + length * np.arange(3 * n)
    return head + starts.astype(">u4").tobytes() + np.full(3 * n, length, ">u4").tobytes() + row.tobytes()


def _pcx(img):
    """PCX RGB (version 5, 3 planes), every byte a one-byte run."""
    import struct

    n = img.shape[0]
    head = struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, n - 1, n - 1, 72, 72) + bytes(48) + bytes([0, 3])
    head = (head + struct.pack("<HH", n, 1)).ljust(128, b"\0")
    data = np.ascontiguousarray(img.transpose(0, 2, 1)).reshape(-1)
    return head + np.stack([np.full_like(data, 0xC1), data], axis=-1).tobytes()


def _icon(img, kind):
    """An ICO (kind 1) or CUR (kind 2) of one 24-bit DIB of img [n, n, 3]
    (n <= 256), its AND mask clear."""
    import struct

    n = img.shape[0]
    info = struct.pack("<IiiHHIIiiII", 40, n, 2 * n, 1, 24, 0, 0, 0, 0, 0, 0)
    dib = info + img[::-1, :, ::-1].tobytes() + bytes(n * ((n + 31) // 32 * 4))
    return struct.pack("<HHH", 0, kind, 1) + struct.pack("<BBBBHHII", n % 256, n % 256, 0, 0, 1, 24, len(dib), 22) + dib


def _qoi(img):
    """QOI RGB, every pixel a QOI_OP_RGB."""
    import struct

    n = img.shape[0]
    px = np.concatenate([np.full((n * n, 1), 0xFE, np.uint8), img.reshape(-1, 3)], axis=1)
    return b"qoif" + struct.pack(">IIBB", n, n, 3, 0) + px.tobytes() + bytes(7) + b"\1"


def _sun(img, rle=True):
    """Sun raster BGR (type 1), or one RLE stream of literals (a 0x80 byte
    as 0x80 0)."""
    import struct

    n = img.shape[0]
    data = np.ascontiguousarray(img[..., ::-1]).reshape(-1)
    if rle:
        esc = data == 0x80
        out = np.zeros(len(data) + int(esc.sum()), np.uint8)
        pos = np.arange(len(data)) + np.cumsum(esc) - esc
        out[pos] = data
        data = out
    return struct.pack(">8I", 0x59A66A95, n, n, 24, len(data), 2 if rle else 1, 0, 0) + data.tobytes()


def _fax(n, compression):
    """A bilevel n x n TIFF of vertical stripes 32 pixels wide (white first)
    coded as CCITT modified Huffman rows (2), T.4 one-dimensional rows after
    an EOL each (3) or T.6 (4: the first row in horizontal mode, each other
    row as vertical-0 codes), MinIsWhite."""
    pairs = n // 64
    pair = "00011011" + "000001101010"  # the T.4 codes of a white and a black run of 32
    row1d = pair * pairs
    if compression == 2:
        row = np.array(list(row1d + "0" * (-len(row1d) % 8)), np.uint8)
        bits = np.tile(row, n)
    elif compression == 3:
        bits = np.tile(np.array(list("000000000001" + row1d), np.uint8), n)
    else:
        first = np.array(list(("001" + pair) * pairs), np.uint8)  # horizontal mode
        bits = np.concatenate([first, np.ones((n - 1) * 2 * pairs, np.uint8), np.array(list("0000000000010000"
                                                                                             "00000001"), np.uint8)])
    strip = np.packbits(bits).tobytes()
    return _tiff_strips(n, n, (1,), 0, [strip], n, compression), (np.arange(n) % 64 < 32)[None, :].repeat(n, 0)


def _fp_predictor(f: np.ndarray) -> bytes:
    """libtiff's floating-point predictor applied to float32 rows [h, w]:
    the big-endian byte planes of each row, then differenced byte by byte."""
    h, w = f.shape
    planes = f.astype(">f4").view(np.uint8).reshape(h, w, 4).transpose(0, 2, 1).reshape(h, 4 * w)
    d = planes.astype(np.int16)
    d[:, 1:] -= planes[:, :-1].astype(np.int16)
    return (d & 255).astype(np.uint8).tobytes()


def _ycbcr_units(img, hs=2, vs=2):
    """YCbCr data units (hs x vs luma, then Cb, Cr) of img [h, w, 3]: the
    green channel as luma, the unit's red and blue as chroma."""
    h, w = img.shape[:2]
    y = img[..., 1].reshape(h // vs, vs, w // hs, hs).transpose(0, 2, 1, 3).reshape(h // vs, w // hs, hs * vs)
    c = img[::vs, ::hs]
    return np.concatenate([y, c[..., :1], c[..., 2:3]], axis=-1).tobytes()


def _thunderscan(gray4):
    """ThunderScan rows of raw-pixel ops (0xC0 | v) of 4-bit gray."""
    return (0xC0 | gray4).astype(np.uint8).tobytes()


def _gray12(v):
    """12-bit samples [h, w] (w even), MSB first, packed."""
    a, b = v[:, 0::2].astype(np.uint32), v[:, 1::2].astype(np.uint32)
    return np.stack([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255], axis=-1).astype(np.uint8).tobytes()


def _lossless_jpeg(img):
    """A lossless JPEG (SOF3, predictor 1, the Annex K DC luminance table)
    of img [n, n, 3]: component 1 the red channel sampled 2x2, components
    2 and 3 green and blue sampled 1x1 (every other row and column), one
    interleaved scan, no markers (RGB); -> (file, the image it decodes to)."""
    import struct

    n = img.shape[0]
    planes = [img[..., 0], img[::2, ::2, 1], img[::2, ::2, 2]]
    code, size = jpeg._huff_codes(*jpeg.STD_HUFFMAN["dc_lum"])
    code, size = np.asarray(code, np.int64), np.asarray(size, np.int64)

    def diffs(p):
        p = p.astype(np.int64)
        pred = np.empty_like(p)
        pred[:, 1:] = p[:, :-1]
        pred[1:, 0] = p[:-1, 0]
        pred[0, 0] = 128
        return p - pred

    dy, d1, d2 = (diffs(p) for p in planes)
    m = n // 2
    units = np.concatenate([dy.reshape(m, 2, m, 2).transpose(0, 2, 1, 3).reshape(m, m, 4), d1[..., None],
                            d2[..., None]], axis=-1).reshape(-1)
    cat = np.where(units == 0, 0, np.floor(np.log2(np.abs(units) + 0.5)).astype(np.int64) + 1)
    cat = np.where(np.abs(units) >= (1 << cat), cat + 1, cat)
    extra = np.where(units > 0, units, units + (1 << cat) - 1)
    value = (code[cat] << cat) | extra
    nbits = size[cat] + cat
    chunks = []
    for lo in range(0, len(value), 1 << 20):
        v, nb = value[lo:lo + (1 << 20)], nbits[lo:lo + (1 << 20)]
        owner = np.repeat(np.arange(len(v)), nb)
        k = np.arange(len(owner)) - np.repeat(np.cumsum(nb) - nb, nb)
        chunks.append(((v[owner] >> (nb[owner] - 1 - k)) & 1).astype(np.uint8))
    bits = np.concatenate(chunks)
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.uint8)])
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    data = np.insert(data, ff + 1, 0)
    dc_bits, dc_vals = jpeg.STD_HUFFMAN["dc_lum"]
    sof = struct.pack(">BHHB", 8, n, n, 3) + bytes([1, 0x22, 0, 2, 0x11, 0, 3, 0x11, 0])
    sos = bytes([3, 1, 0, 2, 0, 3, 0, 1, 0, 0])
    out = (b"\xff\xd8" + jpeg._segment(0xC3, sof) + jpeg._segment(0xC4, bytes([0]) + dc_bits + dc_vals)
           + jpeg._segment(0xDA, sos) + data.tobytes() + b"\xff\xd9")
    up = np.stack([planes[0]] + [np.repeat(np.repeat(p, 2, 0), 2, 1) for p in planes[1:]], axis=-1)
    return out, up

def _format_maps(img):
    """{name: (2048^2 file bytes, the image it must decode to or None)} for
    phase 22a (ICO and CUR 256^2): img [n, n, 3] uint8 of at most 216
    colours (the GIF lossless; the LZMA and lossless JPEG maps built in
    seconds), no byte of it 0x80."""
    import lzma
    import struct
    import zlib

    from vk_gltf_renderer_tpu_torch.ops import bmp, gif, netpbm, tga, tiff

    n = img.shape[0]
    gray = np.ascontiguousarray(img[..., 1])
    rgb = lambda g: np.repeat(g[..., None], 3, axis=-1)  # noqa: E731
    out = {"bmp_rgb24": (bmp.encode_bmp(img), img), "tga_rgb24": (tga.encode_tga(img), img),
           "tiff_raw": (tiff.encode_tiff(img), img), "gif": (gif.encode_gif(img), img),
           "ppm_p6": (netpbm.encode_netpbm(img), img),
           "pgm_16bit": (b"P5\n%d %d\n65535\n" % (n, n) + (gray.astype(">u2") * 257).tobytes(), None)}
    # RLE8: runs of up to 255 pixels of a banded gray image, EOL after each row, EOB
    bands = (np.arange(n) // 64 * 37 % 251).astype(np.uint8)
    runs = []
    for row in range(n):
        v = bands[(np.arange(n // 256) + row // 64) % len(bands)]
        rec = np.empty((n // 256, 4), np.uint8)
        rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3] = 255, v, 1, v
        runs.append(rec.tobytes() + b"\0\0")
    pal = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
    pal[:, 3] = 0
    rle = b"".join(runs) + b"\0\1"
    off = 14 + 40 + 1024
    out["bmp_rle8"] = (b"BM" + struct.pack("<IHHI", off + len(rle), 0, 0, off)
                       + struct.pack("<IiiHHIIiiII", 40, n, n, 1, 8, 1, len(rle), 0, 0, 256, 0) + pal.tobytes() + rle,
                       None)
    # TGA RLE: run packets of 128 pixels along each row
    px = img[::-1, :, ::-1].reshape(n, n // 128, 128, 3)[:, :, 0]
    packets = np.concatenate([np.full((n, n // 128, 1), 0xFF, np.uint8), px], axis=-1)
    out["tga_rle"] = (struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, n, n, 24, 0) + packets.tobytes(), None)
    rows = 64
    strips = [np.ascontiguousarray(img[y:y + rows]).reshape(-1) for y in range(0, n, rows)]
    out["tiff_deflate"] = (_tiff_strips(n, n, (8, 8, 8), 2, [zlib.compress(s.tobytes(), 1) for s in strips], rows, 8),
                           img)
    out["tiff_packbits"] = (_tiff_strips(n, n, (8, 8, 8), 2, [_literal_packbits(s) for s in strips], rows, 32773), img)
    out["tiff_lzw"] = (_tiff_strips(n, n, (8, 8, 8), 2, [_literal_lzw(s) for s in strips], rows, 5), img)
    icon = np.ascontiguousarray(img[:ICON_SIDE, :ICON_SIDE])
    out.update({"psd_raw": (_psd(img, False), img), "psd_packbits": (_psd(img), img),
                "sgi_raw": (_sgi(img, False), img), "sgi_rle": (_sgi(img), img), "pcx_rle": (_pcx(img), img),
                "ico_256_bmp": (_icon(icon, 1), icon), "cur_256_bmp": (_icon(icon, 2), icon),
                "qoi_rgb_ops": (_qoi(img), img), "sun_raw": (_sun(img, False), img), "sun_rle": (_sun(img), img)})
    out["dcx"] = ((987654321).to_bytes(4, "little") + (12).to_bytes(4, "little") + bytes(4) + out["pcx_rle"][0], img)
    out["tiff_lzma"] = (_tiff_strips(n, n, (8, 8, 8), 2, [lzma.compress(s.tobytes(), preset=1) for s in strips], rows,
                                     34925), img)
    for comp, name in ((2, "tiff_ccitt_rle"), (3, "tiff_group3"), (4, "tiff_group4")):
        data, on = _fax(n, comp)
        out[name] = (data, rgb(np.where(on, 255, 0).astype(np.uint8)))
    f = (gray.astype(np.float32) - 100.0) / 7.0
    fstrips = [zlib.compress(_fp_predictor(f[y:y + rows]), 1) for y in range(0, n, rows)]
    out["tiff_float_predictor3"] = (_tiff_strips(n, n, (32,), 1, fstrips, rows, 8, extra=[(317, 3, [3]), (339, 3, [3])]),
                                    rgb(np.clip(f, 0, 255).astype(np.uint8)))
    ystrips = [_literal_lzw(np.frombuffer(_ycbcr_units(img[y:y + rows]), np.uint8)) for y in range(0, n, rows)]
    out["tiff_ycbcr_22_lzw"] = (_tiff_strips(n, n, (8, 8, 8), 6, ystrips, rows, 5), None)
    out["tiff_thunderscan"] = (_tiff_strips(n, n, (4,), 1, [_thunderscan(gray[y:y + rows] >> 4)
                                                           for y in range(0, n, rows)], rows, 32809),
                               rgb((gray >> 4) * 17))
    out["tiff_gray12"] = (_tiff_strips(n, n, (12,), 1, [_gray12(gray[y:y + rows].astype(np.uint16) * 16)
                                                        for y in range(0, n, rows)], rows, 1),
                          rgb(np.minimum(gray.astype(np.int32) * 16, 255).astype(np.uint8)))
    out["jpeg_lossless_2x2"] = _lossless_jpeg(img)
    # PNG's filters one by one and mixed a row at a time, palette, 16-bit and Adam7 PNG; ZSTD, old-style JPEG
    # and CIELab TIFF; BLP (DXT1, palette), FTEX, MSP (RLE) and IM
    half = np.ascontiguousarray(img[: n // 2, : n // 2])  # the single-filter PNGs: png_mixed_filters times every filter
    for name, f in (("png_sub", 1), ("png_average", 3), ("png_paeth", 4)):
        out[name] = (tscenes.png_file(half, 8, 2, filters=f, level=1), half)
    out["png_mixed_filters"] = (tscenes.png_file(img, 8, 2, filters=[0, 1, 2, 3, 4], level=1), img)
    pal, idx, bgra = _palette(img)
    out["png_palette"] = (tscenes.png_file(idx, 8, 3, palette=pal, filters=4, level=1), img)
    out["png_rgb16"] = (tscenes.png_file(img.astype(np.uint16) * 257, 16, 2, filters=4, level=1), img)
    out["png_adam7"] = (tscenes.png_file(img, 8, 2, interlace=True, filters=[1, 4], level=1), img)
    out["tiff_zstd"] = _zstd_tiff(n)
    out["tiff_old_jpeg"] = (_tiff_strips(n, n, (8, 8, 8), 6, [jpeg.encode_jpeg(img)], n, 6), None)
    out["tiff_cielab"] = (_tiff_strips(n, n, (8, 8, 8), 8, [zlib.compress(s.tobytes(), 1) for s in strips], rows, 8),
                          None)
    bc1 = tscenes.bc1_blocks(img)
    out["blp2_dxt1"] = (tscenes.blp2_file(n, n, 2, 0, 0, bgra, bc1), None)
    out["blp2_palette"] = (tscenes.blp2_file(n, n, 1, 0, 0, bgra, idx.tobytes()), img)
    out["ftex_dxt1"] = (tscenes.ftex_file(n, n, 0, bc1), None)
    white = on.copy()
    white[::7] = True  # rows of one byte value: MSP's run packets
    out["msp_rle"] = (tscenes.msp_file(white), rgb(np.where(white, 255, 0).astype(np.uint8)))
    out["im_rgb"] = (tscenes.im_rgb_file(img), img)
    # the readers Pillow's simple plugins read (one map each; PCD is 768 x 512, an ICNS RLE icon at most 128^2)
    g = gray.astype(np.int64)
    out["spider"] = (tscenes.spider_file(gray.astype(np.float32)), rgb(gray))
    out["fits_8"] = (tscenes.fits_file(gray, 8), rgb(gray))
    out["fits_gzip_8"] = (tscenes.fits_file(gray, 8, gzip_tile=True), rgb(gray))
    out["mcidas_16"] = (tscenes.mcidas_file(g, 2, prefix=4), rgb(gray))
    out["gbr_gray"] = (tscenes.gbr_file(gray), rgb(gray))
    out["fli_brun"] = (tscenes.fli_file(n, n, [tscenes.fli_chunk(4, tscenes.fli_palette(_palette256(pal))),
                                              tscenes.fli_chunk(15, tscenes.fli_brun(idx))]), img)
    out["imt"] = (tscenes.imt_file(gray), rgb(gray))
    out["iptc_raw"] = (tscenes.iptc_file(n, n, gray.tobytes()), rgb(gray))
    out["pixar"] = (tscenes.pixar_file(img), img)
    out["im_ycc"] = (tscenes.im_file(b"YCC", n, n, img[::-1].transpose(0, 2, 1).tobytes()), None)
    out["im_rgb3"] = (tscenes.im_file(b"RGB3", n, n, np.stack([img[..., 1], img[..., 0], img[..., 2]])[:, ::-1]
                                       .tobytes()), img)
    out["im_bits12"] = (tscenes.im_file(b"L*12", n, n, tscenes.im_bits(g * 16, 12)),
                        rgb(np.minimum(g * 16, 255).astype(np.uint8)))
    out["pcd"] = (_pcd(img), None)
    icon = np.ascontiguousarray(img[:ICNS_SIDE, :ICNS_SIDE])
    out["icns_it32"] = (_icns(icon), np.concatenate([icon, icon[..., 1:2]], axis=-1))
    return out


def _palette256(pal):
    """A palette of at most 256 colours padded to 256 entries."""
    out = np.zeros((256, 3), np.uint8)
    out[: len(pal)] = pal
    return out


def _pcd(img):
    """A PhotoCD base image whose luma is img's green channel (768 x 512
    from its top-left corner) and whose C1 and C2 are its blue and red at
    every other pixel."""
    y = img[:512, :768, 1] if img.shape[1] >= 768 else np.resize(img[..., 1], (512, 768))
    c = img[:512:2, :768:2] if img.shape[1] >= 768 else np.resize(img[::2, ::2], (256, 384, 3))
    return tscenes.pcd_file(y, c[..., 2], c[..., 0])


def _icns(icon):
    """An ICNS of an it32 icon [128, 128, 3] (literal RLE packets) and its
    t8mk mask (the green channel)."""
    rle = b"".join(tscenes.icns_literal_rle(icon[..., k]) for k in range(3))
    return tscenes.icns_file([(b"it32", bytes(4) + rle), (b"t8mk", np.ascontiguousarray(icon[..., 1]).tobytes())])


def _palette(img):
    """img's colours as a palette: (palette [k, 3], indices [n, n] uint8,
    BLP's 1024-byte BGRA palette)."""
    key = img.reshape(-1, 3).astype(np.int32) @ np.array([1 << 16, 1 << 8, 1], np.int32)
    keys, idx = np.unique(key, return_inverse=True)
    pal = np.stack([keys >> 16, (keys >> 8) & 255, keys & 255], axis=-1).astype(np.uint8)
    bgra = np.zeros((256, 4), np.uint8)
    bgra[: len(pal), :3] = pal[:, ::-1]
    return pal, idx.reshape(img.shape[:2]).astype(np.uint8), bgra.tobytes()


def _zstd_tiff(n):
    """An n x n RGB ZSTD TIFF whose strips are each the committed frame
    tests/data/images/zstd_strip.zst (the card's machine has no zstandard
    package to write one), and the pixels it must decode to: the frame's
    pattern (scenes.zstd_strip_pattern) n wide, tiled."""
    frame = (IMAGE_FIXTURES / "zstd_strip.zst").read_bytes()
    rows = tscenes.ZSTD_STRIP_BYTES // (3 * n)
    k = n // rows
    return (_tiff_strips(n, n, (8, 8, 8), 2, [frame] * k, rows, 50000),
            np.tile(tscenes.zstd_strip_pattern().reshape(rows, n, 3), (k, 1, 1)))


def _formats_fixtures():
    """Phase 22a's fixtures: every committed file against Pillow's digests."""
    import hashlib

    from vk_gltf_renderer_tpu_torch.native import av1_lib, image_lib, j2k_lib, jpeg_lib, zstd_lib
    from vk_gltf_renderer_tpu_torch.ops.dds import UnsupportedCodec
    from vk_gltf_renderer_tpu_torch.utils.image_io import read_image

    image_lib(), jpeg_lib(), zstd_lib(), j2k_lib(), av1_lib()  # built (or found) before the clock starts
    digests = json.loads((IMAGE_FIXTURES / "digests.json").read_text())
    require(not digests["divergences"], f"[formats] divergences listed: {sorted(digests['divergences'])}")
    counts = {"decoded": 0, "refused": 0}
    host_ms = {}
    for name, entry in sorted(digests["files"].items()):
        data = (IMAGE_FIXTURES / name).read_bytes()
        t0 = time.perf_counter()
        try:
            img = read_image(data)
        except ValueError as e:
            require("refused" in entry, f"[formats] {name}: refused ({e!r}) where Pillow decodes it")
            counts["refused"] += 1
            continue
        host_ms[name] = 1e3 * (time.perf_counter() - t0)
        require("refused" not in entry, f"[formats] {name}: decoded where Pillow refuses it")
        if img.shape[2] == 1:
            img = np.concatenate([img] * 3 + [np.full_like(img, 255)], axis=-1)
        elif img.shape[2] == 2:
            img = np.concatenate([img[..., :1]] * 3 + [img[..., 1:]], axis=-1)
        elif img.shape[2] == 3:
            img = np.concatenate([img, np.full_like(img[..., :1], 255)], axis=-1)
        img = np.ascontiguousarray(img)
        require(list(img.shape) == entry["shape"] and hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"],
                f"[formats] {name}: the decode differs from Pillow's digest")
        counts["decoded"] += 1
    for name in sorted(digests["gaps"]):
        try:
            read_image((IMAGE_FIXTURES / name).read_bytes())
        except UnsupportedCodec:
            counts["gaps"] = counts.get("gaps", 0) + 1
            continue
        require(False, f"[formats] {name}: a form the port does not read yet decoded")
    log(f"[formats] (a) {counts['decoded']} fixtures equal to Pillow's digests, {counts['refused']} refused as "
        f"Pillow refuses them, {counts.get('gaps', 0)} not ported yet refused; host ms the slowest "
        f"{max(host_ms.values()):.2f} ({max(host_ms, key=host_ms.get)})")
    return dict(counts=counts, host_ms=host_ms)


def _formats_maps():
    """Phase 22a's maps: host seconds of each format's decode (the coder
    libraries built by _formats_fixtures); the ones whose pixels are known
    read back equal."""
    from vk_gltf_renderer_tpu_torch.utils.image_io import identify_and_read

    base = tscenes.texture_image(MAP_SIDE, seed=7)[..., :3]
    img = (base // 43 * 43).astype(np.uint8)  # at most 216 colours, so that the GIF is lossless
    out = {}
    for name, (data, want) in _format_maps(img).items():
        t0 = time.perf_counter()
        fmt, dec = identify_and_read(data)
        secs = time.perf_counter() - t0
        side = (ICON_SIDE if name.startswith(("ico", "cur")) else ICNS_SIDE if name.startswith("icns")
                else MAP_SIDE // 2 if name in HALF_MAPS else MAP_SIDE)
        shape = PCD_SIZE if name == "pcd" else (side, side)
        require(dec.shape[:2] == shape, f"[formats] {name}: a {dec.shape} decode")
        if want is not None:
            rgba = np.concatenate([dec] * 3 + [np.full_like(dec, 255)], axis=-1) if dec.shape[2] == 1 else dec
            require(np.array_equal(rgba[..., : want.shape[-1]], want), f"[formats] {name}: the map does not read back")
        out[name] = dict(format=fmt, bytes=len(data), side=side, host_s=secs)
        log(f"[formats] (a) {name} ({fmt}) {shape[1]}x{shape[0]}, {len(data)} bytes: host decode {secs:.3f} s"
            + ("; read back equal" if want is not None else ""))
    return out


def _formats_frames(device, tmp, hdr, smi):
    """Phase 22b: the helmet with its base colour in each lossless format,
    each frame equal bit for bit to the frame of a PNG of the same pixels
    (the icon's corner, the bilevel stripes, the upsampled lossless JPEG
    planes, the ZSTD strips' pattern, the old-style JPEG TIFF's planes as
    libtiff converts them), with 10 traverse_bvh4 and 16 gather_channels
    launches."""
    import lzma

    from vk_gltf_renderer_tpu_torch.ops import bmp, gif, netpbm, tga
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.utils.image_io import read_image

    n = FORMATS_TEX
    img = (tscenes.texture_image(n, seed=3)[..., :3] // 43 * 43).astype(np.uint8)
    icon = np.ascontiguousarray(img[:ICON_SIDE, :ICON_SIDE])
    fax, on = _fax(n, 4)
    ljpeg, up = _lossless_jpeg(img)
    pal, idx, bgra = _palette(img)
    zstd_tif, zstd_px = _zstd_tiff(n)
    old_jpeg = _tiff_strips(n, n, (8, 8, 8), 6, [jpeg.encode_jpeg(img)], n, 6)
    pcd = _pcd(img)
    icns_icon = np.ascontiguousarray(img[:ICNS_SIDE, :ICNS_SIDE])
    refs = {"png": img, "png_icon": icon, "png_bilevel": np.repeat(np.where(on, 255, 0).astype(np.uint8)[..., None], 3,
                                                                    axis=-1), "png_up": up, "png_zstd": zstd_px,
            "png_old_jpeg": read_image(old_jpeg)[..., :3],  # libtiff's conversion of the JPEG's raw planes
            "png_gray": np.repeat(img[..., 1:2], 3, axis=-1), "png_pcd": read_image(pcd),  # the PhotoYCC conversion
            "png_icns": np.concatenate([icns_icon, icns_icon[..., 1:2]], axis=-1)}
    strips = [np.ascontiguousarray(img[y:y + 32]).reshape(-1) for y in range(0, n, 32)]
    files = {"bmp": (bmp.encode_bmp(img), "base.bmp", "png"), "tga": (tga.encode_tga(img), "base.tga", "png"),
             "tiff_lzw": (_tiff_strips(n, n, (8, 8, 8), 2, [_literal_lzw(s) for s in strips], 32, 5), "base.tif",
                          "png"),
             "gif": (gif.encode_gif(img), "base.gif", "png"), "ppm": (netpbm.encode_netpbm(img), "base.ppm", "png"),
             "psd": (_psd(img), "base.psd", "png"), "sgi": (_sgi(img), "base.rgb", "png"),
             "pcx": (_pcx(img), "base.pcx", "png"), "ico": (_icon(icon, 1), "base.ico", "png_icon"),
             "qoi": (_qoi(img), "base.qoi", "png"), "sun": (_sun(img), "base.ras", "png"),
             "tiff_lzma": (_tiff_strips(n, n, (8, 8, 8), 2, [lzma.compress(s.tobytes()) for s in strips], 32, 34925),
                           "base_lzma.tif", "png"),
             "tiff_group4": (fax, "base_g4.tif", "png_bilevel"), "jpeg_lossless_2x2": (ljpeg, "base.jpg", "png_up"),
             "png_palette": (tscenes.png_file(idx, 8, 3, palette=pal, filters=4), "base_palette.png", "png"),
             "png_rgb16": (tscenes.png_file(img.astype(np.uint16) * 257, 16, 2, filters=4), "base_rgb16.png", "png"),
             "png_adam7": (tscenes.png_file(img, 8, 2, interlace=True, filters=[1, 4]), "base_adam7.png", "png"),
             "tiff_zstd": (zstd_tif, "base_zstd.tif", "png_zstd"),
             "blp_palette": (tscenes.blp2_file(n, n, 1, 0, 0, bgra, idx.tobytes()), "base.blp", "png"),
             "im": (tscenes.im_rgb_file(img), "base.im", "png"),
             "tiff_old_jpeg": (old_jpeg, "base_ojpeg.tif", "png_old_jpeg"),
             "fits": (tscenes.fits_file(img[..., 1], 8), "base.fits", "png_gray"),
             "flc": (tscenes.fli_file(n, n, [tscenes.fli_chunk(4, tscenes.fli_palette(_palette256(pal))),
                                             tscenes.fli_chunk(15, tscenes.fli_brun(idx))]), "base.flc", "png"),
             "pcd": (pcd, "base.pcd", "png_pcd"), "icns": (_icns(icns_icon), "base.icns", "png_icns")}
    d = os.path.join(tmp, "formats22")
    os.makedirs(d, exist_ok=True)
    frames, firsts = {}, {}
    for kind, (data, name, ref) in [(k, (encode_png(v), k + ".png", None)) for k, v in refs.items()] + list(files.items()):
        r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
        r.create_scene(tscenes.helmet_with_texture(d, data, name))
        r.create_hdr(hdr)
        rows, side = refs[ref or kind].shape[:2]
        require(r.dev_scene.tex_desc[0, 1:3].tolist() == [side, rows], f"[formats] {kind}: the base colour did not "
                                                                       f"decode")
        tb4.COUNTER.launches = 0
        tgather.COUNTER.launches = 0
        times, _, first = _render_frames(r, 0, 1)
        launches = {"traverse_bvh4": tb4.COUNTER.launches, "gather_channels": tgather.COUNTER.launches}
        require(launches == {"traverse_bvh4": 10, "gather_channels": 16},
                f"[formats] {kind}: launches a frame {launches}, not 10 and 16")
        if ref is None:
            firsts[kind] = first
        else:
            require(all(np.array_equal(a, b) for a, b in zip(first, firsts[ref])),
                    f"[formats] the {kind} frame differs from the {ref} frame")
        frames[kind] = dict(ms=1e3 * times[0], launches=launches, tex_side=side)
        log(f"[formats] (b) helmet {FRAME_W}x{FRAME_H} with a {side}x{rows} {kind} base colour: "
            f"{1e3 * times[0]:.2f} ms, traverse_bvh4 {launches['traverse_bvh4']} and gather_channels "
            f"{launches['gather_channels']} launches" + (f"; equal to the {ref} frame bit for bit" if ref else "")
            + f"; on {smi}")
        del r
    return frames


def _formats_headless(device, tmp, hdr, smi):
    """Phase 22c: headless --output in every new suffix, read back."""
    import io
    from contextlib import redirect_stdout

    from vk_gltf_renderer_tpu_torch import headless
    from vk_gltf_renderer_tpu_torch.utils.image_io import WRITABLE, read_image

    os.environ["VKGR_SETTINGS"] = os.path.join(tmp, "settings22.json")
    outs = {}
    for suffix in [".png"] + [s for s in WRITABLE if s not in (".png", ".jpg", ".jpeg", ".webp")]:
        path = os.path.join(tmp, "headless22" + suffix)
        with redirect_stdout(io.StringIO()):
            rc = headless.main(["--headless", "--scenefile", os.path.join(tmp, "helmet.gltf"), "--hdrfile", hdr,
                                "--envSystem", "1", "--size", str(FRAME_W), str(FRAME_H), "--frames", "1",
                                "--output", path, "--device", str(device)])
        require(rc == 0, f"headless --output {path}: rc {rc}")
        with open(path, "rb") as f:
            outs[suffix] = f.read()
    png = read_image(outs[".png"])[..., :3].astype(np.int32)
    res = {}
    for suffix, data in outs.items():
        if suffix == ".png":
            continue
        got = read_image(data)
        rgb = (np.repeat(got, 3, axis=-1) if got.shape[2] == 1 else got[..., :3]).astype(np.int32)
        require(rgb.shape == png.shape, f"[formats] headless {suffix}: shape {rgb.shape}")
        err = np.abs(rgb - png)
        if suffix == ".gif":
            share, worst = float((err > 0).any(-1).mean()), int(err.max())
            # a sanity bound (a wrong palette or index order errs by tens on average): the measured share and
            # error go into the JSON line
            require(worst < 128 and float(err.mean()) < 8.0,
                    f"[formats] headless .gif: the median cut strays (largest channel error {worst}, mean "
                    f"{float(err.mean()):.2f})")
            res[suffix] = dict(bytes=len(data), differing_share=share, max_channel_err=worst,
                               mean_abs_err=float(err.mean()))
            log(f"[formats] (c) headless --output x.gif at {FRAME_W}x{FRAME_H}: {len(data)} bytes, "
                f"{100 * share:.2f}% of pixels differ from the PNG output, largest channel error {worst}, mean "
                f"{float(err.mean()):.3f} (the median cut of {len(np.unique(png.reshape(-1, 3), axis=0))} colours)")
        else:
            require(not err.any(), f"[formats] headless {suffix} differs from the PNG output")
            res[suffix] = dict(bytes=len(data))
    log(f"[formats] (c) headless --output at {FRAME_W}x{FRAME_H} in "
        f"{', '.join(s for s in res if s != '.gif')}: each read back equal to the PNG output; on {smi}")
    return res


def _formats_jpeg2000(device, tmp, hdr, smi):
    """Phase 22d: JPEG 2000. The committed maps that only this phase decodes
    (a 2048x2048 lossy JP2, a 512x512 lossless codestream) equal to the
    digests of Pillow's decode, host seconds each; then the helmet at 1080p
    on the 2048x2048 map and on a PNG the port writes from the decoded
    pixels, and on the ICNS icon whose ic07 entry is a JPEG 2000 codestream
    and on a PNG of its pixels: each pair of frames equal bit for bit, with
    10 traverse_bvh4 and 16 gather_channels launches a frame."""
    import hashlib

    from vk_gltf_renderer_tpu_torch.native import j2k_lib
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.utils.image_io import identify_and_read

    j2k_lib()  # built (or found) before the clock starts
    digests = json.loads((IMAGE_FIXTURES / "digests.json").read_text())
    maps, pixels, raw = {}, {}, {}
    for name, entry in sorted(digests["large"].items()):
        if not name.startswith("j2k_"):
            continue
        data = (IMAGE_FIXTURES / name).read_bytes()
        t0 = time.perf_counter()
        fmt, dec = identify_and_read(data)
        secs = time.perf_counter() - t0
        require(fmt == "JPEG2000" and list(dec.shape) == entry["shape"]
                and hashlib.sha256(np.ascontiguousarray(dec).tobytes()).hexdigest() == entry["sha256"],
                f"[formats] {name}: the decode differs from Pillow's digest")
        h, w = dec.shape[:2]
        maps[name] = dict(bytes=len(data), side=w, bits_per_pixel=8 * len(data) / (w * h), host_s=secs)
        pixels[name], raw[name] = dec, data
        log(f"[formats] (d) {name} {w}x{h}, {len(data)} bytes ({8 * len(data) / (w * h):.3f} bits a pixel): "
            f"host decode {secs:.3f} s, equal to Pillow's digest; on {smi}")
    icns = "icns_jpeg2000_ic07.icns"
    icns_data = (IMAGE_FIXTURES / icns).read_bytes()
    fmt, icns_px = identify_and_read(icns_data)
    require(fmt == "ICNS" and hashlib.sha256(np.ascontiguousarray(icns_px).tobytes()).hexdigest()
            == digests["files"][icns]["sha256"], f"[formats] {icns}: the decode differs from Pillow's digest")
    lossy = "j2k_map_2048_lossy.jp2"
    cases = [("png_jpeg2000_2048", encode_png(np.ascontiguousarray(pixels[lossy][..., :3])), "j2k_pixels.png", None),
             ("jpeg2000_2048", raw[lossy], "base.jp2", "png_jpeg2000_2048"),
             ("png_icns_jpeg2000", encode_png(np.ascontiguousarray(icns_px)), "icns_pixels.png", None),
             ("icns_jpeg2000", icns_data, "base.icns", "png_icns_jpeg2000")]
    d = os.path.join(tmp, "formats22d")
    os.makedirs(d, exist_ok=True)
    frames, firsts = {}, {}
    for kind, data, name, ref in cases:
        r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
        r.create_scene(tscenes.helmet_with_texture(d, data, name))
        r.create_hdr(hdr)
        side, rows = r.dev_scene.tex_desc[0, 1:3].tolist()
        want = pixels[lossy] if "2048" in kind else icns_px
        require([rows, side] == list(want.shape[:2]), f"[formats] {kind}: the base colour did not decode")
        tb4.COUNTER.launches = 0
        tgather.COUNTER.launches = 0
        times, _, first = _render_frames(r, 0, 1)
        launches = {"traverse_bvh4": tb4.COUNTER.launches, "gather_channels": tgather.COUNTER.launches}
        require(launches == {"traverse_bvh4": 10, "gather_channels": 16},
                f"[formats] {kind}: launches a frame {launches}, not 10 and 16")
        if ref is None:
            firsts[kind] = first
        else:
            require(all(np.array_equal(a, b) for a, b in zip(first, firsts[ref])),
                    f"[formats] the {kind} frame differs from the {ref} frame")
        frames[kind] = dict(ms=1e3 * times[0], launches=launches, tex_side=side)
        log(f"[formats] (d) helmet {FRAME_W}x{FRAME_H} with a {side}x{rows} {kind} base colour: "
            f"{1e3 * times[0]:.2f} ms, traverse_bvh4 {launches['traverse_bvh4']} and gather_channels "
            f"{launches['gather_channels']} launches" + (f"; equal to the {ref} frame bit for bit" if ref else "")
            + f"; on {smi}")
        del r
    return dict(maps=maps, frames=frames)


def _formats_avif(device, tmp, hdr, smi):
    """Phase 22e: AVIF. The committed maps that only this phase decodes (a
    512x512 coded lossless map at 4:4:4, a 2048x2048 lossy one at Pillow's
    defaults: quality 75, speed 6, 4:2:0, the deblocking filter on, and the
    same image at speed 2 with enable-cdef=1: CDEF and loop restoration on,
    which its header is held to) equal to the digests of Pillow's decode,
    host seconds each (the best of three); then the helmet at 1080p on each
    map and on a PNG the port writes from its decoded pixels: each pair of
    frames equal bit for bit, with 10 traverse_bvh4 and 16 gather_channels
    launches a frame."""
    import hashlib

    from vk_gltf_renderer_tpu_torch.native import av1_lib
    from vk_gltf_renderer_tpu_torch.ops import avif as tavif
    from vk_gltf_renderer_tpu_torch.ops import gather as tgather
    from vk_gltf_renderer_tpu_torch.ops import traverse_bvh4 as tb4
    from vk_gltf_renderer_tpu_torch.renderer import GltfRenderer
    from vk_gltf_renderer_tpu_torch.utils.image_io import identify_and_read

    av1_lib()  # built (or found) before the clock starts
    digests = json.loads((IMAGE_FIXTURES / "digests.json").read_text())
    maps, frames = {}, {}
    d = os.path.join(tmp, "formats22e")
    os.makedirs(d, exist_ok=True)
    for name, tag in (("avif_map_512_lossless.avif", "512"), ("avif_map_2048_lossy.avif", "2048_lossy"),
                      ("avif_map_2048_cdef_lr.avif", "2048_cdef_lr")):
        entry = digests["large"][name]
        data = (IMAGE_FIXTURES / name).read_bytes()
        items, primary, idat = tavif._parse(data)
        head = tavif.av1_header(tavif._item_data(data, items[primary], idat))
        filters = {k: head[k] for k in ("cdef_bits", "cdef_y_strength", "cdef_uv_strength", "lr_unit_y",
                                         "lr_uv_shift", "sb128")}
        filters.update({k: tavif.LR_TYPES[head[k]] for k in ("lr_type_y", "lr_type_u", "lr_type_v")})
        if "cdef_lr" in tag:
            require(head["cdef_strength"] > 0 and head["lr_planes"] > 0 and not head["refused"],
                    f"[formats] {name}: not a frame of CDEF and loop restoration ({filters})")
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            fmt, dec = identify_and_read(data)
            secs.append(time.perf_counter() - t0)
        rgba = np.concatenate([dec, np.full(dec.shape[:2] + (1,), 255, np.uint8)], axis=-1)
        require(fmt == "AVIF" and list(rgba.shape) == entry["shape"]
                and hashlib.sha256(rgba.tobytes()).hexdigest() == entry["sha256"],
                f"[formats] {name}: the decode differs from Pillow's digest")
        h, w = dec.shape[:2]
        maps[name] = dict(bytes=len(data), side=w, bits_per_pixel=8 * len(data) / (w * h), host_s=min(secs),
                          host_s_runs=secs, filters=filters)
        log(f"[formats] (e) {name} {w}x{h}, {len(data)} bytes ({8 * len(data) / (w * h):.3f} bits a pixel): "
            f"host decode {min(secs):.3f} s (best of 3; {', '.join(f'{x:.3f}' for x in secs)}), equal to "
            f"Pillow's digest; {filters}; on {smi}")
        first_png = None
        for kind, blob, fname in ((f"png_avif_{tag}", encode_png(np.ascontiguousarray(dec)), f"avif_{tag}.png"),
                                  (f"avif_{tag}", data, f"base_{tag}.avif")):
            r = GltfRenderer(FRAME_W, FRAME_H, spp=SPP, max_depth=DEPTH, device=device)
            r.create_scene(tscenes.helmet_with_texture(d, blob, fname))
            r.create_hdr(hdr)
            side, rows = r.dev_scene.tex_desc[0, 1:3].tolist()
            require([rows, side] == [h, w], f"[formats] {kind}: the base colour did not decode")
            tb4.COUNTER.launches = 0
            tgather.COUNTER.launches = 0
            times, _, first = _render_frames(r, 0, 1)
            launches = {"traverse_bvh4": tb4.COUNTER.launches, "gather_channels": tgather.COUNTER.launches}
            require(launches == {"traverse_bvh4": 10, "gather_channels": 16},
                    f"[formats] {kind}: launches a frame {launches}, not 10 and 16")
            if first_png is None:
                first_png = first
            else:
                require(all(np.array_equal(a, b) for a, b in zip(first, first_png)),
                        f"[formats] the {kind} frame differs from the png_avif_{tag} frame")
            frames[kind] = dict(ms=1e3 * times[0], launches=launches, tex_side=side)
            log(f"[formats] (e) helmet {FRAME_W}x{FRAME_H} with a {side}x{rows} {kind} base colour: "
                f"{1e3 * times[0]:.2f} ms, traverse_bvh4 {launches['traverse_bvh4']} and gather_channels "
                f"{launches['gather_channels']} launches" + (f"; equal to the png_avif_{tag} frame bit for bit"
                                                             if kind == f"avif_{tag}" else "") + f"; on {smi}")
            del r
    return dict(maps=maps, frames=frames)


def phase_pillow_formats(device, tmp, hdr, smi):
    """Phase 22: Pillow's other formats, JPEG 2000 and AVIF (the module docstring)."""
    t_phase = time.perf_counter()
    out = {"fixtures": _formats_fixtures()}
    log(f"[time] phase 22 (a) fixtures done at {time.perf_counter() - t_phase:.1f} s into the phase")
    out["maps"] = _formats_maps()
    log(f"[time] phase 22 (a) done at {time.perf_counter() - t_phase:.1f} s into the phase")
    out["frames"] = _formats_frames(device, tmp, hdr, smi)
    log(f"[time] phase 22 (b) done at {time.perf_counter() - t_phase:.1f} s into the phase")
    out["headless"] = _formats_headless(device, tmp, hdr, smi)
    j2k = _formats_jpeg2000(device, tmp, hdr, smi)
    out["jpeg2000_maps"] = j2k["maps"]
    out["frames"].update(j2k["frames"])
    log(f"[time] phase 22 (d) done at {time.perf_counter() - t_phase:.1f} s into the phase")
    t_avif = time.perf_counter()
    avif = _formats_avif(device, tmp, hdr, smi)
    out["avif_maps"] = avif["maps"]
    out["frames"].update(avif["frames"])
    out["avif_seconds"] = time.perf_counter() - t_avif
    log(f"[time] phase 22 (e) AVIF {out['avif_seconds']:.1f} s")
    out["launches_per_frame"] = out["frames"]["png"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[time] Pillow's other formats phase {out['seconds']:.1f} s")
    return out


def _entry(name, launches, nums, **extra):
    """One kernel's object in the kernels JSON line."""
    src, replaces, also = SOURCES[name]
    e = {"name": name, "route": "cuda", "source": SRC + src, "replaces": replaces}
    if also:
        e["also_replaces"] = also
    e["launches"] = launches
    for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"):
        e[key] = nums[key]
    e["library_ms"] = nums.get("library_ms")
    e.update({k: v for k, v in nums.items() if k not in e})
    e.update(extra)
    return e


def main():
    t_start = time.perf_counter()
    device, smi = phase_device()
    resources = phase_build()
    kern, helmet_r, helmet_rays = phase_kernels(device, resources)
    with tempfile.TemporaryDirectory() as tmp:
        launches, ms, mrays, helmet_first = phase_main_path(device, tmp, smi)
        checks = phase_correctness(device, tmp)
        log(f"[time] helmet phases done at {time.perf_counter() - t_start:.1f} s")

        from vk_gltf_renderer_tpu_torch.scenes import write_large_glb, write_synthetic_hdr

        glb = os.path.join(tmp, "terrain.glb")
        hdr = write_synthetic_hdr(os.path.join(tmp, "sky.hdr"), 256, 512, seed=0)
        world = write_large_glb(glb, LARGE_TRIS)
        require(world == LARGE_WORLD_TRIS, f"terrain has {world} world triangles")
        large, terrain_r, terrain_rays = phase_large_kernels(device, glb, hdr, resources)
        log(f"[time] large-scene kernels done at {time.perf_counter() - t_start:.1f} s")
        frames = phase_terrain_frames(device, glb, hdr, smi, tmp)
        log(f"[time] terrain frames done at {time.perf_counter() - t_start:.1f} s")
        helmet, _, _ = helmet_renderer(tmp, device)
        helmet.create_scene(os.path.join(tmp, "helmet.gltf"))
        helmet.create_hdr(hdr)
        terrain, _ = terrain_renderer(glb, hdr, device, SELECTIONS[0])
        replay = phase_replay(device, (("helmet", helmet), ("terrain", terrain)), smi)
        log(f"[time] main-path launch replay done at {time.perf_counter() - t_start:.1f} s")
        replays = phase_replay_selections(device, (("helmet", helmet), ("terrain", terrain)), smi)
        log(f"[time] {', '.join(map(str, REPLAYS.values()))} launch replays done at "
            f"{time.perf_counter() - t_start:.1f} s")
        mega = phase_megakernel(device, (("helmet", helmet), ("terrain", terrain)), smi)
        log(f"[time] megakernel A/B done at {time.perf_counter() - t_start:.1f} s")
        split = {"helmet": phase_split_kernels(device, "helmet", helmet_r, *helmet_rays),
                 "terrain": phase_split_kernels(device, "terrain", terrain_r, *terrain_rays)}
        del helmet, terrain, helmet_r
        log(f"[time] split-table kernels done at {time.perf_counter() - t_start:.1f} s")
        helmet_path = os.path.join(tmp, "helmet.gltf")
        packet4 = phase_packet4_frames(device, (("terrain", glb, hdr, frames[SELECTIONS[0]]["first"]),
                                                ("helmet", helmet_path, hdr, helmet_first)), smi)
        log(f"[time] packet4 frames done at {time.perf_counter() - t_start:.1f} s")
        wave = phase_wavefront_frame(device, helmet_path, hdr, smi)
        log(f"[time] wavefront frame done at {time.perf_counter() - t_start:.1f} s")
        front = phase_frontends(device, tmp, glb, smi)
        log(f"[time] front ends done at {time.perf_counter() - t_start:.1f} s")
        scenes = material_scenes(tmp)
        material = phase_material_frames(device, scenes, smi)
        march = phase_march_replay(device, scenes, smi)
        log(f"[time] material scenes done at {time.perf_counter() - t_start:.1f} s")
        anim = phase_animation(device, tmp, hdr, smi, terrain_r)
        log(f"[time] animation and refit done at {time.perf_counter() - t_start:.1f} s")
        alpha = phase_alpha(device, tmp, hdr, smi)
        log(f"[time] alpha and the plane done at {time.perf_counter() - t_start:.1f} s")
        viewer = phase_viewer(device, tmp, hdr, smi)
        log(f"[time] guides, denoise, TAAU and preview done at {time.perf_counter() - t_start:.1f} s")
        editor = phase_editor(device, tmp, hdr, smi)
        log(f"[time] editor and viewer done at {time.perf_counter() - t_start:.1f} s")
        textures = phase_textures_devices(device, tmp, hdr, smi, terrain_r.dev_bvh)
        del terrain_r
        log(f"[time] textures and devices done at {time.perf_counter() - t_start:.1f} s")
        slice21 = phase_sbvh_seed_batch_webp(device, tmp, hdr, smi)
        log(f"[time] SBVH, seeding, batching and WebP done at {time.perf_counter() - t_start:.1f} s")
        slice22 = phase_pillow_formats(device, tmp, hdr, smi)
        log(f"[time] Pillow's other formats done at {time.perf_counter() - t_start:.1f} s")
    probes = phase_probes(device)
    log(f"[time] probes done at {time.perf_counter() - t_start:.1f} s")
    probes.update(phase_stream_uarch(device))
    log(f"[time] stream and micro-op probes done at {time.perf_counter() - t_start:.1f} s")

    kernels = [
        _entry("traverse_bvh4", launches["traverse_bvh4"], kern["traverse_bvh4"],
               headless_launches=front["launches"]["traverse_bvh4"],
               terrain_launches=frames[SELECTIONS[0]]["launches"]["traverse_bvh4"],
               terrain=large["traverse_bvh4"], resources=resources["traverse_bvh4.cu"],
               replay={label: v["frame"] for label, v in replay.items()},
               replay_launches={label: [[x["hit"], x["lanes"], x["live"], x["traverse_bvh4"], x["v7"], x["bound_ms"]]
                                        for x in v["launches"]] for label, v in replay.items()},
               replay_launches_fields=["hit", "lanes", "live", "ms", "v7_ms", "bound_ms"],
               material_launches_per_frame={label: {k: v for k, v in m["per_frame"].items() if k != "gather_channels"}
                                            for label, m in material.items()},
               march_replay={label: v["frame"] for label, v in march.items()},
               march_launches={label: [[x["lanes"], x["live"], x["hits"], x["ms"], x["plain_ms"], x["bound_ms"]]
                                       for x in v["launches"]] for label, v in march.items()},
               march_launches_fields=["lanes", "live", "hits", "ms", "plain_ms", "bound_ms"],
               alpha_launches_per_frame=alpha["replay"]["launches_per_frame"],
               alpha_replay=alpha["replay"]["frame"],
               alpha_launches=alpha["replay"]["launches"], alpha_launches_fields=alpha["replay"]["launches_fields"],
               foliage=alpha["kernels"]["traverse_bvh4"],
               viewer_launches_per_frame={label: v["traverse_bvh4"]
                                          for label, v in viewer["launches_per_frame"].items()},
               pick_launches=len(PICK_PIXELS),
               editor_launches_per_render=[r["traverse_bvh4"] for r in editor["edit_cli"]["renders"]],
               viewer_keyframe_launches=[fr["traverse_bvh4"] for fr in editor["viewer"]["frames"]],
               textured_launches_per_frame={k: v["launches_per_frame"]["traverse_bvh4"]
                                            for k, v in textures["frames"].items()},
               mesh_launches_per_frame={k: v["launches_per_frame"]["traverse_bvh4"]
                                        for k, v in textures["mesh"].items() if k != "adaptive"},
               boundary_launches={k: v["launches"]["traverse_bvh4"] for k, v in textures["boundary"].items()}),
        _entry("gather_channels", launches["gather_channels"], kern["gather_channels"],
               headless_launches=front["launches"]["gather_channels"],
               material_launches_per_frame={label: m["per_frame"]["gather_channels"]
                                            for label, m in material.items()},
               viewer_launches_per_frame={label: v["gather_channels"]
                                          for label, v in viewer["launches_per_frame"].items()},
               viewer_keyframe_launches=[fr["gather_channels"] for fr in editor["viewer"]["frames"]],
               textured_launches_per_frame={k: v["launches_per_frame"]["gather_channels"]
                                            for k, v in textures["frames"].items()},
               mesh_launches_per_frame={k: v["launches_per_frame"]["gather_channels"]
                                        for k, v in textures["mesh"].items() if k != "adaptive"}),
    ]
    for name, sel in (("traverse_bvh2", ("v2", "v2")), ("traverse_bvh16", ("v6", "v6")),
                      ("traverse_lanes", ("lane", "lane_stream")),
                      ("traverse_bvh4_multipop", ("v5", "v5")), ("traverse_bvh4_sidecar", ("v7", "v7")),
                      ("traverse_bvh4_leafqueue", ("v3", "v8"))):
        extra = {"helmet": kern[name]} if name in BVH4_VARIANTS else {}
        if name == "traverse_bvh4_sidecar":  # phase 7b: v7 on the (v3, v9) frame's lanes
            extra.update(resources=resources[SOURCES[name][0]],
                         replay={label: dict(ms=v["frame"]["v7"], bound_ms=v["frame"]["bound_ms"],
                                             live=v["frame"]["live"], rays=v["frame"]["rays"],
                                             traverse_bvh4_ms=v["frame"]["traverse_bvh4"])
                                 for label, v in replay.items()},
                         replay_launches={label: [[x["hit"], x["lanes"], x["live"], x["v7"], x["bound_ms"]]
                                                  for x in v["launches"]] for label, v in replay.items()},
                         replay_launches_fields=["hit", "lanes", "live", "ms", "bound_ms"])
        if name in REPLAYS:
            beside = ["traverse_bvh4_ms"] if name in BESIDE_BVH4 else []
            extra.update(resources=resources[SOURCES[name][0]],
                         replay={label: v["frame"] for label, v in replays[name].items()},
                         replay_launches={label: [[x["hit"], x["lanes"], x["live"], x["ms"], x["bound_ms"]]
                                                  + [x["traverse_bvh4"] for _ in beside]
                                                  for x in v["launches"]] for label, v in replays[name].items()},
                         replay_launches_fields=["hit", "lanes", "live", "ms", "bound_ms"] + beside)
        kernels.append(_entry(name, frames[sel]["launches"][name], large[name], **extra))
    kernels.append(_entry("render_mega", mega[("terrain", 5)]["launches"], mega[("terrain", 5)],
                          resources=resources["megakernel.cu"],
                          runs={f"{label},depth{depth}": v for (label, depth), v in mega.items()},
                          boundary_launches={k: v["launches"]["render_mega"] for k, v in textures["boundary"].items()}))
    kernels.append(_entry("traverse_bvh4_split", packet4["terrain"]["launches"],
                          split["terrain"]["traverse_bvh4_split"], helmet=split["helmet"]["traverse_bvh4_split"],
                          helmet_launches=packet4["helmet"]["launches"],
                          resources=resources["traverse_bvh4_split.cu"],
                          replay={label: v["replay"]["frame"] for label, v in packet4.items()},
                          replay_launches={label: [[x["hit"], x["lanes"], x["live"], x["ms"], x["traverse_bvh4"],
                                                    x["bound_ms"]] for x in v["replay"]["launches"]]
                                           for label, v in packet4.items()},
                          replay_launches_fields=["hit", "lanes", "live", "ms", "traverse_bvh4_ms", "bound_ms"]))
    # v1 has no renderer path: its launches are those of phase 9's two intersect_rays_packet
    # calls on the terrain; its replay is the (v2, v2) frames' launches (phase 7b)
    v1_replay = replays["traverse_bvh2_split"]
    kernels.append(_entry("traverse_bvh2_split", split["terrain"]["traverse_bvh2_split"]["launches"],
                          split["terrain"]["traverse_bvh2_split"], helmet=split["helmet"]["traverse_bvh2_split"],
                          launches_of="phase 9: intersect_rays_packet(v2=False), closest hit and "
                                      "anyhit=True, on the terrain's probe rays",
                          resources=resources["traverse_bvh2_split.cu"],
                          replay={label: v["frame"] for label, v in v1_replay.items()},
                          replay_launches={label: [[x["hit"], x["lanes"], x["live"], x["ms"], x["traverse_bvh2"],
                                                    x["bound_ms"], x["id_ties"]] for x in v["launches"]]
                                           for label, v in v1_replay.items()},
                          replay_launches_fields=["hit", "lanes", "live", "ms", "traverse_bvh2_ms", "bound_ms",
                                                  "id_ties"]))
    for name in ("probe_nodefetch", "probe_visit", "probe_stream_dma", "probe_uarch"):
        kernels.append(_entry(name, probes[name]["launches"], probes[name]))
    for e in kernels:  # phase 21: the SBVH frames' launches, each kernel on the SBVH tables
        if e["name"] in ("traverse_bvh4", "gather_channels"):
            e["sbvh_seed_batch_launches"] = {k: v[e["name"]] for k, v in slice21["launches"].items()}
        if e["name"] in slice21["sbvh"]["soup"]["kernels"]:
            e["sbvh_soup"] = slice21["sbvh"]["soup"]["kernels"][e["name"]]
        if e["name"] in ("traverse_bvh4", "gather_channels"):  # phase 22b: a frame of each base-colour format
            e["formats_launches_per_frame"] = {k: v["launches"][e["name"]] for k, v in slice22["frames"].items()}
    terrain = {f"{p},{q}": {"ms_per_frame": frames[(p, q)]["ms"], "mrays_per_s": frames[(p, q)]["mrays"]}
               for p, q in SELECTIONS}
    log(f"[time] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "frame_ms": ms, "mrays_per_s": mrays,
                      "frame": f"{FRAME_W}x{FRAME_H} spp{SPP} depth{DEPTH} helmet stand-in + HDR",
                      "terrain_frames": terrain,
                      "packet4_frames": {k: {"ms_per_frame": v["ms"], "mrays_per_s": v["mrays"]}
                                         for k, v in packet4.items()},
                      "wavefront_frame": wave,
                      "headless": front["headless"], "bench_impl": front["bench"],
                      "profiles": {label: {k: v for k, v in prof.items() if k != "top"}
                                   for label, prof in front["profiles"].items()},
                      "terrain_frame": f"{FRAME_W}x{FRAME_H} spp{SPP} depth{DEPTH} terrain "
                                       f"{LARGE_WORLD_TRIS} tris + HDR",
                      "material_frames": {label: {k: v for k, v in m.items() if k != "launches"}
                                          for label, m in material.items()},
                      "card_vs_cpu": checks, "animation": anim,
                      "alpha": {k: v for k, v in alpha.items() if k not in ("replay", "kernels")},
                      "foliage_kernels": alpha["kernels"],
                      "viewer": {k: v for k, v in viewer.items() if k != "launches_per_frame"},
                      "editor": editor, "textures_devices": textures,
                      "sbvh_seed_batch_webp": {k: v for k, v in slice21.items() if k != "launches"},
                      "pillow_formats": {k: v for k, v in slice22.items() if k != "launches_per_frame"}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
